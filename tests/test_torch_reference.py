"""The port's parity tests against the JAX package hold the port against
the JAX package's native planner, or fail saying which planner each side
runs.

The JAX package builds its planner library straight into its output path
(``spfx/cpp/build.py``) and keeps a failed load for the life of the
process (``spfx.symbolic._native``). Test workers that start together
without a built library can load another worker's half-written file and
then plan every matrix with the numpy minimum-degree fallback, whose
ordering is not the native AMD's. ``ensure_reference_planner`` repairs
that state: it builds the JAX package's own ``planner.cpp`` under the
port's build directory (a private name, then a rename) and loads it into
the JAX package's bridge. Every port test file that plans with the JAX
package calls it at import, and ``one_torch_thread``.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytest.importorskip("jax")

import spfx.cpp
from spfx.symbolic import _native as jnative
from spfx.symbolic.analyze import analyze as janalyze
from spfx.utils.config import Config as JConfig

from spfx_torch.cpp.build import build_dir
from spfx_torch.io import generate
from spfx_torch.symbolic import _native as tnative
from spfx_torch.symbolic.analyze import analyze
from spfx_torch.utils.config import Config

REF_LIB = "libspfxplanner_ref.so"


def build_reference_planner(out_dir: str | None = None):
    """The JAX package's ``planner.cpp`` built with its own flags into
    ``out_dir`` (the port's build directory by default) and loaded, or
    None where it does not build. Builds to a private name and renames, so
    no process loads another's half-written library; never writes into
    the JAX package."""
    src = os.path.join(os.path.dirname(os.path.abspath(spfx.cpp.__file__)),
                       "planner.cpp")
    out = os.path.join(out_dir or build_dir(), REF_LIB)
    if not (os.path.exists(out)
            and os.path.getmtime(out) > os.path.getmtime(src)):
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", src, "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError:
            return None
        if res.returncode != 0:
            return None
        os.replace(tmp, out)
    try:
        return ctypes.CDLL(out)
    except OSError:
        return None


def _name(native: bool) -> str:
    return "the native planner" if native else "the numpy fallback"


def check_same_planner() -> None:
    """Assert that both packages plan with the same planner."""
    j, t = jnative.available(), tnative.available()
    assert j == t, (f"the JAX package plans with {_name(j)}, the port with "
                    f"{_name(t)}: their orderings differ")


def ensure_reference_planner() -> None:
    """Load the native planner into the JAX package if it lost the build
    (and ``SPFX_NO_NATIVE`` is unset), then ``check_same_planner``."""
    if not jnative.available() and not os.environ.get("SPFX_NO_NATIVE"):
        lib = build_reference_planner()
        if lib is not None:
            jnative._register(lib)
            jnative._LIB = lib
            jnative._TRIED = True
    check_same_planner()


def one_torch_thread() -> None:
    """One torch intra-op thread in this test process. Test workers
    (pytest-xdist) share the machine's cores, and torch's default of one
    thread per core in each worker oversubscribes them, which slows the
    port's many small tensor operations far more than the threads
    gain."""
    torch.set_num_threads(1)


ensure_reference_planner()
one_torch_thread()


def _spd(n, seed=0):
    """The random SPD matrix of tests/test_mega.py."""
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B @ B.T + sp.diags(np.full(n, n * 0.1)))


MATRICES = {"lap6": lambda: generate.laplacian_3d(6),
            "spd300": lambda: _spd(300)}


@pytest.fixture
def lost_race():
    """The JAX bridge in the state of a worker that lost the build race:
    its load failed and is kept; restored afterwards."""
    if not tnative.available():
        pytest.skip("no native planner on this machine: both packages run "
                    "the numpy fallback")
    saved = jnative._LIB, jnative._TRIED
    jnative._LIB, jnative._TRIED = None, True
    try:
        assert not jnative.available()
        yield
    finally:
        jnative._LIB, jnative._TRIED = saved


@pytest.mark.parametrize("name", list(MATRICES))
def test_helper_repairs_lost_race(lost_race, name):
    A = MATRICES[name]()
    ensure_reference_planner()
    assert jnative.available()
    np.testing.assert_array_equal(janalyze(A, JConfig()).perm,
                                  analyze(A, Config()).perm)


@pytest.mark.parametrize("name", list(MATRICES))
def test_lost_race_shows_without_helper(lost_race, name):
    A = MATRICES[name]()
    jperm, perm = janalyze(A, JConfig()).perm, analyze(A, Config()).perm
    assert (jperm != perm).any()
    with pytest.raises(AssertionError, match="JAX package plans with the "
                       "numpy fallback, the port with the native planner"):
        check_same_planner()


def test_reference_build_stays_outside_the_jax_package(tmp_path):
    lib = build_reference_planner(str(tmp_path))
    if lib is None:
        pytest.skip("no C++ compiler on this machine")
    assert sorted(os.listdir(tmp_path)) == [REF_LIB]
    assert hasattr(lib, "spfx_amd")


def test_planners_agree_at_import():
    check_same_planner()
