"""Build the native symbolic planner shared library.

The library goes into the package's build directory (``spfx_torch/_build``),
not into the source tree.

Usage: python -m spfx_torch.cpp.build
"""

from __future__ import annotations

import os
import subprocess
import sys


def build_dir() -> str:
    """The port's build directory (created on demand, listed in .gitignore)."""
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def build(quiet: bool = False) -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "planner.cpp")
    out = os.path.join(build_dir(), "libspfxplanner.so")
    if os.path.exists(out) and os.path.getmtime(out) > os.path.getmtime(src):
        return out
    # build to a private name, then rename: concurrent builders (test
    # workers) never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           src, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        if not quiet:
            sys.stderr.write(res.stderr)
        raise RuntimeError(f"planner build failed: {res.stderr[:500]}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build())
