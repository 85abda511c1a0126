"""Batched small dense solvers of the recommender (per-user and per-item
regularized normal equations).

Port of spfx/kernels/dense.py. The JAX functions call ``lax.linalg``'s
Cholesky and triangular solves, library calls and no Pallas kernel; here
they are ``torch.linalg`` calls. The default rank is 64, past
``cholesky_small_batched``'s c <= 32. Nothing here waits for the device:
``cholesky_ex(check_errors=False)`` reads no ``info`` back, so a matrix
that is not positive definite gives a factor with NaN or garbage rows, as
JAX's gives NaN, and the calls can be captured into a CUDA graph.
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import matmul


def batched_cholesky(A):
    """(B, k, k) SPD -> lower Cholesky factors. Reads the lower triangle
    only (JAX: ``symmetrize_input=False``): whatever lies above the
    diagonal, NaN included, does not reach the factor."""
    L, _ = torch.linalg.cholesky_ex(A, check_errors=False)
    return L


def batched_chol_solve(A, B):
    """Solve A X = B for (B, k, k) SPD A, (B, k, m) B, via chol + two
    triangular solves."""
    L = batched_cholesky(A)
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-2, -1), Y, upper=True)


def regularized_gram(Y, lam):
    """G = Y^T Y + lam I — shared Gramian for iALS updates (k x k)."""
    k = Y.shape[-1]
    G = matmul.bmm(Y.t()[None], Y[None])[0]
    return G + lam * torch.eye(k, dtype=Y.dtype, device=Y.device)
