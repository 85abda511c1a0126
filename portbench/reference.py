"""The plain reference that decides ``correct``. NumPy, SciPy and plain
PyTorch; it imports nothing of the program under test.

A factor says P A P^T = L L^T (Cholesky) or P A P^T = L U (LU, L unit
lower); a solution says A X = B. Both are judged by what they say, in
float64, against the matrix the benchmark made itself:

- ``factor_backward_error``: the largest normwise backward error of the
  factor along seeded probe vectors z, |P A P^T z - L (U z)|_inf /
  (|A|_inf |z|_inf), with U = L^T for Cholesky. A float32 factor reads
  about 1e-7; a wrong one reads order 1.
- ``scaled_residual``: the largest over the columns of |b - A x|_inf /
  (|A|_inf |x|_inf + |b|_inf).

The control is this reference put in the program's place at the nearest
precision below float32 with TF32 off, which is TF32: ``dense_cholesky``
and ``dense_lu`` factor a small dense matrix by blocks, their trailing
products on operands rounded to ``mantissa`` bits (10 for TF32).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

TF32_MANTISSA = 10


def check_permutation(perm, n: int) -> np.ndarray:
    """``perm`` as int64 if it is a permutation of 0..n-1, else raise."""
    p = np.asarray(perm, dtype=np.int64)
    if p.shape != (n,) or not np.array_equal(np.sort(p), np.arange(n)):
        raise ValueError("the factor's permutation is not one of 0..n-1")
    return p


def factor_backward_error(A, perm, rows, cols, lvals, uvals=None,
                          probes: int = 4, seed: int = 0) -> float:
    """The backward error of a factor of A along ``probes`` seeded normal
    vectors. L holds ``lvals`` at (rows, cols) (rows >= cols: the lower
    triangle, in the permuted order); U holds ``uvals`` at (cols, rows),
    or is L^T when ``uvals`` is None."""
    A = sp.csc_matrix(A, dtype=np.float64)
    n = A.shape[0]
    p = check_permutation(perm, n)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.size and (rows < cols).any():
        raise ValueError("L has an entry above its diagonal")
    L = sp.csc_matrix((np.asarray(lvals, np.float64), (rows, cols)),
                      shape=(n, n))
    U = L.T.tocsr() if uvals is None else sp.csr_matrix(
        (np.asarray(uvals, np.float64), (cols, rows)), shape=(n, n))
    Z = np.random.default_rng(seed).standard_normal((n, probes))
    W = np.empty_like(Z)
    W[p] = Z
    PAPz = (A @ W)[p]
    gap = np.abs(PAPz - L @ (U @ Z)).max(axis=0)
    anorm = abs(A).sum(axis=1).max()
    return float((gap / (anorm * np.abs(Z).max(axis=0))).max())


def scaled_residual(A, X, B) -> float:
    """max_j |b_j - A x_j|_inf / (|A|_inf |x_j|_inf + |b_j|_inf)."""
    A = sp.csr_matrix(A, dtype=np.float64)
    X = np.asarray(X, np.float64).reshape(A.shape[0], -1)
    B = np.asarray(B, np.float64).reshape(A.shape[0], -1)
    anorm = abs(A).sum(axis=1).max()
    r = np.abs(B - A @ X).max(axis=0)
    den = anorm * np.abs(X).max(axis=0) + np.abs(B).max(axis=0)
    return float((r / den).max())


def round_mantissa(x: torch.Tensor, bits: int | None) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties away) at ``bits`` explicit
    mantissa bits; unchanged when ``bits`` is None."""
    if bits is None:
        return x
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def _mm(a, b, bits):
    return round_mantissa(a, bits) @ round_mantissa(b, bits)


def dense_cholesky(A, mantissa: int | None = None, nb: int = 32):
    """L (float32, dense) with A = L L^T, right-looking by blocks of
    ``nb``; the trailing updates on operands rounded to ``mantissa``
    bits."""
    M = torch.as_tensor(np.asarray(A), dtype=torch.float32).clone()
    n = M.shape[0]
    for k in range(0, n, nb):
        e = min(k + nb, n)
        M[k:e, k:e] = torch.linalg.cholesky(M[k:e, k:e])
        if e < n:
            # L21 = A21 L11^{-T}
            M[e:, k:e] = torch.linalg.solve_triangular(
                M[k:e, k:e].mT, M[e:, k:e], upper=True, left=False)
            M[e:, e:] -= _mm(M[e:, k:e], M[e:, k:e].mT, mantissa)
    return torch.tril(M)


def dense_lu(A, mantissa: int | None = None, nb: int = 32):
    """(L unit lower, U upper), float32 dense, A = L U without pivoting,
    right-looking by blocks of ``nb``; the trailing updates on operands
    rounded to ``mantissa`` bits."""
    M = torch.as_tensor(np.asarray(A), dtype=torch.float32).clone()
    n = M.shape[0]
    for k in range(0, n, nb):
        e = min(k + nb, n)
        for j in range(k, e):                  # unblocked on the block
            M[j + 1:e, j] /= M[j, j]
            M[j + 1:e, j + 1:e] -= torch.outer(M[j + 1:e, j],
                                               M[j, j + 1:e])
        if e < n:
            L11 = torch.tril(M[k:e, k:e], -1) + torch.eye(e - k)
            U11 = torch.triu(M[k:e, k:e])
            M[k:e, e:] = torch.linalg.solve_triangular(
                L11, M[k:e, e:], upper=False, unitriangular=True)
            M[e:, k:e] = torch.linalg.solve_triangular(
                U11, M[e:, k:e], upper=True, left=False)
            M[e:, e:] -= _mm(M[e:, k:e], M[k:e, e:], mantissa)
    return torch.tril(M, -1) + torch.eye(n), torch.triu(M)
