"""ctypes bridge to the C++ symbolic planner (spfx/cpp/planner.cpp).

The reference's entire symbolic layer is native C (Cholesky/Source/
SparseFrame.c:693-1978). spfx keeps symbolic analysis on the host too, with a
C++ fast path for the O(nnz(L)) traversals (etree, column counts, supernodal
pattern) and a pure-numpy fallback with identical semantics. Tests
cross-validate the two.

Build: ``python -m spfx_torch.cpp.build`` (or tests/bench build it on demand).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "_build", "libspfxplanner.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        # try to build it quietly; fall back to numpy on any failure
        try:
            from spfx_torch.cpp.build import build

            build(quiet=True)
        except Exception:
            pass
    if os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
            _register(lib)
            _LIB = lib
        except OSError:
            _LIB = None
    return _LIB


def _register(lib):
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.spfx_etree.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
    lib.spfx_etree.restype = None
    lib.spfx_col_counts.argtypes = [ctypes.c_int64, i64p, i32p, i64p, i64p]
    lib.spfx_col_counts.restype = None
    lib.spfx_sn_pattern_count.argtypes = [
        ctypes.c_int64, i64p, i32p, i64p, i64p, ctypes.c_int64, i64p]
    lib.spfx_sn_pattern_count.restype = ctypes.c_int64
    lib.spfx_sn_pattern_fill.argtypes = [
        ctypes.c_int64, i64p, i32p, i64p, i64p, ctypes.c_int64, i64p, i64p]
    lib.spfx_sn_pattern_fill.restype = None
    lib.spfx_amd.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
    lib.spfx_amd.restype = ctypes.c_int64
    lib.spfx_camd.argtypes = [ctypes.c_int64, i64p, i32p, i64p, i64p]
    lib.spfx_camd.restype = ctypes.c_int64


def available() -> bool:
    if os.environ.get("SPFX_NO_NATIVE"):
        return False
    return _load() is not None


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def etree(n, indptr, indices) -> np.ndarray:
    lib = _load()
    indptr, indices = _i64(indptr), _i32(indices)
    parent = np.empty(n, dtype=np.int64)
    lib.spfx_etree(n, _p64(indptr), _p32(indices), _p64(parent))
    return parent


def col_counts(n, indptr, indices, parent) -> np.ndarray:
    lib = _load()
    indptr, indices, parent = _i64(indptr), _i32(indices), _i64(parent)
    counts = np.empty(n, dtype=np.int64)
    lib.spfx_col_counts(n, _p64(indptr), _p32(indices), _p64(parent),
                        _p64(counts))
    return counts


def sn_pattern(n, indptr, indices, parent, sn_of,
               nsuper) -> tuple[np.ndarray, np.ndarray]:
    """Per-supernode row patterns: returns (sn_ptr, sn_rows)."""
    lib = _load()
    indptr, indices = _i64(indptr), _i32(indices)
    parent, sn_of = _i64(parent), _i64(sn_of)
    sn_ptr = np.zeros(nsuper + 1, dtype=np.int64)
    total = lib.spfx_sn_pattern_count(n, _p64(indptr), _p32(indices),
                                      _p64(parent), _p64(sn_of), nsuper,
                                      _p64(sn_ptr))
    sn_rows = np.empty(total, dtype=np.int64)
    lib.spfx_sn_pattern_fill(n, _p64(indptr), _p32(indices), _p64(parent),
                             _p64(sn_of), nsuper, _p64(sn_ptr), _p64(sn_rows))
    return sn_ptr, sn_rows


def amd(n, indptr, indices) -> np.ndarray | None:
    lib = _load()
    indptr, indices = _i64(indptr), _i32(indices)
    perm = np.empty(n, dtype=np.int64)
    rc = lib.spfx_amd(n, _p64(indptr), _p32(indices), _p64(perm))
    if rc != 0:
        return None
    return perm


def camd(n, indptr, indices, cons) -> np.ndarray | None:
    """Constrained quotient-graph AMD: classes eliminated in ascending
    order, min-degree within the active class (ref camd_l2,
    Cholesky/Source/SparseFrame.c:777-862)."""
    lib = _load()
    indptr, indices, cons = _i64(indptr), _i32(indices), _i64(cons)
    perm = np.empty(n, dtype=np.int64)
    rc = lib.spfx_camd(n, _p64(indptr), _p32(indices), _p64(cons),
                       _p64(perm))
    if rc != 0:
        return None
    return perm


def _register_solves(lib):
    import ctypes
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    for name, vp in [("spfx_chol_solve_f32", f32p),
                     ("spfx_chol_solve_f64", f64p)]:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, i64p,
                       vp, f64p]
        fn.restype = None
    for name, vp in [("spfx_lu_solve_f32", f32p),
                     ("spfx_lu_solve_f64", f64p)]:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, i64p,
                       vp, vp, f64p]
        fn.restype = None


def _bshift(sym, plan):
    if plan.below_shift is None:
        return np.zeros(sym.nsuper, dtype=np.int64)
    return _i64(plan.below_shift)


def _solve_ptr(a):
    import ctypes
    if a.dtype == np.float32:
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), "f32"
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), "f64"


def chol_solve_host(sym, plan, Lh: np.ndarray, x: np.ndarray) -> None:
    """In-place host supernodal solve L L^T x = b (x holds b on entry)."""
    lib = _load()
    if not hasattr(lib, "_solves_registered"):
        _register_solves(lib)
        lib._solves_registered = True
    ptr, tag = _solve_ptr(Lh)
    fn = getattr(lib, f"spfx_chol_solve_{tag}")
    import ctypes
    sh = _bshift(sym, plan)
    fn(sym.nsuper, _p64(_i64(sym.sn_start)), _p64(_i64(sym.sn_ptr)),
       _p64(_i64(sym.sn_rows)), _p64(_i64(plan.offsets)),
       _p64(_i64(plan.strides)), _p64(sh), ptr,
       x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))


def lu_solve_host(sym, plan, Lh: np.ndarray, Uh: np.ndarray,
                  x: np.ndarray) -> None:
    """In-place host supernodal solve L U x = b (x holds b on entry)."""
    lib = _load()
    if not hasattr(lib, "_solves_registered"):
        _register_solves(lib)
        lib._solves_registered = True
    lptr, tag = _solve_ptr(Lh)
    uptr, _ = _solve_ptr(Uh)
    fn = getattr(lib, f"spfx_lu_solve_{tag}")
    import ctypes
    sh = _bshift(sym, plan)
    fn(sym.nsuper, _p64(_i64(sym.sn_start)), _p64(_i64(sym.sn_ptr)),
       _p64(_i64(sym.sn_rows)), _p64(_i64(plan.offsets)),
       _p64(_i64(plan.strides)), _p64(sh), lptr, uptr,
       x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
