"""Residual validation (ref SparseFrame_validate,
Cholesky/Source/SparseFrame.c:3141-3266): synthesize a right-hand side,
solve, and report the scaled residual
``||A x - b||_inf / (||A||_1 ||x||_inf + ||b||_inf)`` (ref :3262)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def synth_rhs(A: sp.spmatrix, seed: int = 0,
              cplx: bool = False) -> np.ndarray:
    """Deterministic RHS like the reference's synthesized B (:3182-3193);
    with ``cplx``, complex: real and imaginary parts drawn in turn from
    the same generator (the real part is then not the real RHS)."""
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    if cplx:
        return rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return rng.standard_normal(n)


def scaled_residual(A: sp.spmatrix, x: np.ndarray, b: np.ndarray) -> float:
    A = sp.csc_matrix(A)
    r = A @ x - b
    anorm = np.abs(A).sum(axis=0).max()      # 1-norm
    denom = anorm * np.abs(x).max() + np.abs(b).max()
    return float(np.abs(r).max() / denom)


def validate(factor, b: np.ndarray | None = None, refine: int | None = None):
    """End-to-end check: returns (x, scaled_residual)."""
    A = factor.A
    if b is None:
        b = synth_rhs(A)
    x = factor.solve(b, refine=refine)
    return x, scaled_residual(A, x, b)
