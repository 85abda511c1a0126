"""CLI driver: read -> analyze -> factorize -> solve -> validate per matrix.

Port of spfx/__main__.py, with the same options and output lines: takes
MatrixMarket paths, runs the whole pipeline on each, and prints the
per-phase wall times and the scaled residual.

    python -m spfx_torch [options] [--device cpu] matrix1.mtx matrix2.mtx ...

The factorizations and solves run on the CUDA device unless ``--device``
names another (``--device cpu`` takes every kernel's plain PyTorch
version). While matrix k factorizes, a prefetch thread reads, analyzes and
plans matrix k + 1: host work only.

``--dtype complex64`` or ``complex128`` factorizes in that type (a complex
MatrixMarket file, or a real one taken as complex) and solves against a
complex right-hand side (``synth_rhs(A, cplx=True)``). A Hermitian matrix
is not symmetric, so ``--engine auto`` sends it to LU; ``--engine chol``
takes the Hermitian Cholesky.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import scipy.sparse as sp


def _is_symmetric(A: sp.spmatrix) -> bool:
    d = (A - A.T).tocoo()
    if d.nnz == 0:
        return True
    return bool(np.abs(d.data).max() <= 1e-14 * np.abs(A.data).max())


def prepare(path: str, args):
    """Host-only half of the pipeline: read + analyze + plan. Runs on the
    prefetch thread while the previous matrix factorizes on the device."""
    import spfx_torch
    from spfx_torch.io.matrix_market import read_matrix

    t0 = time.perf_counter()
    A = read_matrix(path)
    read_t = time.perf_counter() - t0
    engine = args.engine
    if engine == "auto":
        engine = "chol" if _is_symmetric(A) and not args.static_pivot \
            else "lu"
    cfg = spfx_torch.Config(dtype=args.dtype, ordering=args.ordering,
                            refine_iters=args.refine,
                            static_pivot=args.static_pivot,
                            profile=args.profile)
    t0 = time.perf_counter()
    kind = spfx_torch.Cholesky if engine == "chol" else spfx_torch.LU
    ctx = kind(A, cfg, device=args.device)
    analyze_t = time.perf_counter() - t0
    return A, ctx, engine, read_t, analyze_t


def run_one(path: str, args, prep=None) -> int:
    from spfx_torch.validate import scaled_residual, synth_rhs

    try:
        A, ctx, engine, read_t, analyze_t = \
            prep if prep is not None else prepare(path, args)
    except Exception as e:
        print(f"{path}: read/analyze FAILED: {e}", file=sys.stderr)
        return 1
    n, nnz = A.shape[0], A.nnz
    print(f"{path}: n={n} nnz={nnz} engine={engine} dtype={args.dtype}")
    sym = ctx.sym
    print(f"  nsuper={sym.nsuper} levels={int(sym.sn_level.max()) + 1} "
          f"nnzL={sym.nnzL} flops={ctx.plan.flops:.3e}")

    t0 = time.perf_counter()
    try:
        f = ctx.factorize(A)
        arr = f.L if engine == "chol" else f.Lx
        _ = float(arr[:1].real.cpu()[0])            # force completion
    except Exception as e:
        print(f"  factorize FAILED: {e}", file=sys.stderr)
        return 1
    fact_t = time.perf_counter() - t0

    b = synth_rhs(A, cplx="complex" in args.dtype)
    t0 = time.perf_counter()
    x = f.solve(b)
    solve_t = time.perf_counter() - t0
    resid = scaled_residual(A, x, b)

    gfs = ctx.plan.flops / fact_t / 1e9
    print(f"  read {read_t:.3f}s  analyze {analyze_t:.3f}s  "
          f"factorize {fact_t:.3f}s ({gfs:.1f} GFLOP/s)  "
          f"solve {solve_t:.3f}s")
    print(f"  residual {resid:.3e}")
    if args.save_factor:
        from spfx_torch.checkpoint import save_factor
        out = os.path.join(args.save_factor,
                           os.path.basename(path) + ".factor.npz")
        save_factor(out, f)
        print(f"  factor saved to {out}")
    return 0 if resid < args.resid_gate else 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spfx_torch",
        description="spfx_torch sparse direct solver demo driver")
    ap.add_argument("paths", nargs="+", help="MatrixMarket (.mtx[.gz]) files")
    ap.add_argument("--engine", choices=["auto", "chol", "lu"],
                    default="auto")
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64", "complex64", "complex128"])
    ap.add_argument("--ordering", default="auto",
                    choices=["auto", "nd", "amd", "camd", "rcm", "identity"])
    ap.add_argument("--refine", type=int, default=3,
                    help="iterative refinement sweeps on solve")
    ap.add_argument("--static-pivot", action="store_true",
                    help="greedy max-magnitude row matching before LU")
    ap.add_argument("--profile", action="store_true",
                    help="per-phase timers; SPFX_PROFILE_DIR captures a "
                         "torch.profiler trace around factorize")
    ap.add_argument("--resid-gate", type=float, default=1e-8,
                    help="exit nonzero if scaled residual exceeds this")
    ap.add_argument("--save-factor", default=None, metavar="DIR",
                    help="save each factor as DIR/<name>.factor.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch versions)")
    args = ap.parse_args(argv)
    rc = 0
    # 2-wide pipeline: prefetch the next matrix's host work while the
    # current one runs on the device
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(prepare, args.paths[0], args)
        for i, path in enumerate(args.paths):
            try:
                prep = fut.result()
            except Exception as e:
                print(f"{path}: read/analyze FAILED: {e}", file=sys.stderr)
                rc = max(rc, 1)
                prep = None
            if i + 1 < len(args.paths):
                fut = pool.submit(prepare, args.paths[i + 1], args)
            if prep is not None:
                rc = max(rc, run_one(path, args, prep))
    return rc


if __name__ == "__main__":
    sys.exit(main())
