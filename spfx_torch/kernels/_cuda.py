"""Build and load the port's hand-written CUDA kernels.

Each source under ``spfx_torch/kernels/csrc/`` compiles with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, in the
package's build directory ``spfx_torch/_build/``. The builds of all sources
start together, one ``nvcc`` each, at the first launch of any kernel (or
when ``build()`` is called). The libraries load with ``ctypes``: every
pointer and the stream go as ``c_void_p``, and every C entry point returns
``cudaGetLastError()``, which ``check()`` turns into an exception.

Every wrapper counts its launches here, so a run can show which kernels
its main path went through.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess

from spfx_torch.cpp.build import build_dir

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong
_vp = ctypes.c_void_p

# whole-panel kernels: (widths, nbelow, inputs..., outputs..., workspace,
# B, cp, rbp, stream)
_PANEL_CHOL = [_vp] * 7 + [_c_int] * 3 + [_vp]
_PANEL_LU = [_vp] * 11 + [_c_int] * 3 + [_vp]

# C signatures of the entry points, by library
_SIGNATURES = {
    "window_gather": {
        "spfx_window_gather2": [_vp, _c_ll, _c_int, _vp, _c_int, _c_ll, _vp,
                                _vp, _c_int, _c_ll, _vp, _vp],
    },
    "potrf_inv": {
        "spfx_potrf_inv_f32": [_vp, _vp, _vp, _vp, _c_int, _c_int, _vp],
        "spfx_potrf_inv_f64": [_vp, _vp, _vp, _vp, _c_int, _c_int, _vp],
    },
    "getrf_inv": {
        "spfx_getrf_inv_f32": [_vp, _vp, _vp, _vp, _vp, _vp, _c_int, _c_int,
                               _vp],
        "spfx_getrf_inv_f64": [_vp, _vp, _vp, _vp, _vp, _vp, _c_int, _c_int,
                               _vp],
    },
    "panel_lanes": {f"spfx_{kind}_panel_lanes_{t}": sig
                    for kind, sig in (("chol", _PANEL_CHOL),
                                      ("lu", _PANEL_LU))
                    for t in ("f32", "f64")},
    "panel_wide": {f"spfx_{kind}_panel_wide_{t}": sig
                   for kind, sig in (("chol", _PANEL_CHOL),
                                     ("lu", _PANEL_LU))
                   for t in ("f32", "f64")},
    # (slab, Rs, csp, rows, RE, E, vec, stream); the twin (rows2) takes
    # two slabs and two E: (slab_l, slab_u, Rs, csp, rows, RE, EL, EU, vec,
    # stream)
    "extend_add": {**{f"spfx_extend_add_rows_{t}": [_vp, _c_ll, _c_int, _vp,
                                                    _c_ll, _vp, _c_int, _vp]
                      for t in ("f32", "f64")},
                   **{f"spfx_extend_add_rows2_{t}": [_vp, _vp, _c_ll, _c_int,
                                                     _vp, _c_ll, _vp, _vp,
                                                     _c_int, _vp]
                      for t in ("f32", "f64")}},
    # (A, B, S, G, batch, n, m, k, stream)
    "syrk_gemm": {f"spfx_syrk_gemm_{p}_{t}": [_vp] * 4 + [_c_int] * 4
                  + [_vp] for p in ("general", "bulk")
                  for t in ("f32", "f64")},
    # (D, L, batch, c, stream)
    "chol_small": {f"spfx_cholesky_small_batched_{t}": [_vp, _vp, _c_int,
                                                        _c_int, _vp]
                   for t in ("f32", "f64")},
    # complex diagonal blocks, the signatures of potrf_inv and getrf_inv
    "potrf_inv_c": {f"spfx_potrf_inv_{t}": [_vp, _vp, _vp, _vp, _c_int,
                                            _c_int, _vp]
                    for t in ("c64", "c128")},
    "getrf_inv_c": {f"spfx_getrf_inv_{t}": [_vp] * 6 + [_c_int, _c_int, _vp]
                    for t in ("c64", "c128")},
    # (A, A's batch and row strides, B, B's batch and column strides, C,
    # batch, m, n, k, tile_m, tile_n, stream)
    "bmm_bf16x3": {"spfx_bmm_bf16x3_fast_f32": [_vp, _c_ll, _c_ll, _vp,
                                                _c_ll, _c_ll, _vp]
                   + [_c_int] * 6 + [_vp]},
    # (F, x, widths, nbelow, diag_start, below_start, xcols, xrows, yg[,
    # ws], cnt, B, cp, rbp, nrhs, ch, nbuf[, unit], stream)
    "level_solve": {**{f"spfx_level_solve_fwd_{t}": [_vp] * 10 + [_c_int] * 7
                       + [_vp] for t in ("f32", "f64")},
                    **{f"spfx_level_solve_bwd_{t}": [_vp] * 11 + [_c_int] * 6
                       + [_vp] for t in ("f32", "f64")}},
}

_libs: dict = {}
build_log: dict = {}          # source name -> nvcc's output (ptxas -v)

_launches = {"window_gather2": 0, "window_gather": 0, "potrf_inv": 0,
             "getrf_inv": 0, "chol_panel_lanes": 0, "lu_panel_lanes": 0,
             "chol_panel_wide": 0, "lu_panel_wide": 0, "extend_add_rows": 0,
             "syrk_gemm_batched": 0, "cholesky_small_batched": 0,
             "potrf_inv_c": 0, "getrf_inv_c": 0, "bmm_bf16x3": 0,
             "level_solve": 0}


def count(name: str) -> None:
    """Record one launch of kernel ``name`` (called right at the launch)."""
    _launches[name] += 1


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return exe


def _out_path(name: str) -> str:
    return os.path.join(build_dir(), f"lib{name}.so")


def stale(out: str, src: str, headers) -> bool:
    """Whether library ``out`` must be built again: it is missing, or not
    newer than its source ``src`` or any of ``headers`` (a header may be
    included by several sources, so an edit to it rebuilds them all)."""
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(f) >= built for f in (src, *headers))


def build() -> dict:
    """Compile every stale source, all ``nvcc`` processes started together.
    Returns {source name: nvcc output} for the sources it compiled; raises
    on any failure."""
    todo = []
    headers = glob.glob(os.path.join(_CSRC, "*.cuh"))
    for src in sorted(glob.glob(os.path.join(_CSRC, "*.cu"))):
        name = os.path.splitext(os.path.basename(src))[0]
        out = _out_path(name)
        if not stale(out, src, headers):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        todo.append((name, out, tmp,
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in todo:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return build_log


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name`` (building all stale sources
    first)."""
    if name not in _libs:
        build()
        so = ctypes.CDLL(_out_path(name))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
        _libs[name] = so
    return _libs[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
