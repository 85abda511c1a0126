"""The plain reference that decides ``correct``. NumPy, SciPy and plain
PyTorch; it imports nothing of the program under test.

A factor says P A P^T = L L^H (Cholesky; L L^T for real values) or
P A P^T = L U (LU, L unit lower, U never conjugated); a solution says
A X = B. Both are judged by what they say, in float64 (complex128 where A,
the factor or the solution is complex), against the matrix the benchmark
made itself:

- ``factor_backward_error``: the largest normwise backward error of the
  factor along seeded probe vectors z, |P A P^T z - L (U z)|_inf /
  (|A|_inf |z|_inf), with U = L^H for Cholesky. A float32 factor reads
  about 1e-7; a wrong one reads order 1.
- ``scaled_residual``: the largest over the columns of |b - A x|_inf /
  (|A|_inf |x|_inf + |b|_inf).

Each configuration is judged in its own arithmetic, by its rung of the
precision ladder (``LADDER``, keyed by the configuration's
``program_config["dtype"]``, float32 by default):

============  ==========  ================  ===============================
dtype         check in    dense control     card control (``calibrate``)
============  ==========  ================  ===============================
float32       float64     10 bits (TF32)    ``matmul_precision="default"``
float64       float64     23 bits (float32) the program at float32
complex64     complex128  10 bits a part    ``matmul_precision="default"``
complex128    complex128  23 bits a part    the program at complex64
============  ==========  ================  ===============================

The control is the nearest precision below the configuration's, put in
the program's place. On the CPU it is this reference: ``dense_cholesky``
and ``dense_lu`` factor a small dense matrix by blocks in the
configuration's dtype, their trailing products on operands rounded to the
rung's ``mantissa`` bits (on each part of a complex value). On the card it
is the program with the rung's ``control`` merged into its configuration.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

TF32_MANTISSA = 10
FLOAT32_MANTISSA = 23


# the precision ladder, keyed by the configuration's dtype: ``check``, the
# dtype the check computes in; ``mantissa``, the dense control's explicit
# mantissa bits (on each part); ``control``, the card control, merged into
# the configuration
_TF32 = {"program_config": {"matmul_precision": "default"}}
LADDER = {
    "float32": {"check": "float64", "mantissa": TF32_MANTISSA,
                "control": _TF32},
    "float64": {"check": "float64", "mantissa": FLOAT32_MANTISSA,
                "control": {"program_config": {"dtype": "float32"}}},
    "complex64": {"check": "complex128", "mantissa": TF32_MANTISSA,
                  "control": _TF32},
    "complex128": {"check": "complex128", "mantissa": FLOAT32_MANTISSA,
                   "control": {"program_config": {"dtype": "complex64"}}},
}


def dtype_of(config: dict) -> str:
    """The configuration's dtype, the key of its rung."""
    return config["program_config"].get("dtype", "float32")


def rung(config: dict) -> dict:
    """The configuration's row of ``LADDER``."""
    return LADDER[dtype_of(config)]


def working(*arrays) -> type:
    """The dtype the check computes in: complex128 where any of
    ``arrays`` is complex, else float64 (the ladder's ``check``)."""
    return np.complex128 if any(np.iscomplexobj(a) for a in arrays) \
        else np.float64


def check_permutation(perm, n: int) -> np.ndarray:
    """``perm`` as int64 if it is a permutation of 0..n-1, else raise."""
    p = np.asarray(perm, dtype=np.int64)
    if p.shape != (n,) or not np.array_equal(np.sort(p), np.arange(n)):
        raise ValueError("the factor's permutation is not one of 0..n-1")
    return p


def factor_backward_error(A, perm, rows, cols, lvals, uvals=None,
                          probes: int = 4, seed: int = 0) -> float:
    """The backward error of a factor of A along ``probes`` seeded normal
    vectors (complex ones, real and imaginary parts drawn in turn from the
    seed's stream, where anything is complex). L holds ``lvals`` at
    (rows, cols) (rows >= cols: the lower triangle, in the permuted
    order); U holds ``uvals`` at (cols, rows), or is L^H when ``uvals`` is
    None."""
    lvals = np.asarray(lvals)
    uvals = None if uvals is None else np.asarray(uvals)
    work = working(A, lvals, uvals)
    A = sp.csc_matrix(A, dtype=work)
    n = A.shape[0]
    p = check_permutation(perm, n)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.size and (rows < cols).any():
        raise ValueError("L has an entry above its diagonal")
    L = sp.csc_matrix((np.asarray(lvals, work), (rows, cols)), shape=(n, n))
    U = L.conj().T.tocsr() if uvals is None else sp.csr_matrix(
        (np.asarray(uvals, work), (cols, rows)), shape=(n, n))
    g = np.random.default_rng(seed)
    Z = g.standard_normal((n, probes))
    if work is np.complex128:
        Z = Z + 1j * g.standard_normal((n, probes))
    W = np.empty_like(Z)
    W[p] = Z
    PAPz = (A @ W)[p]
    gap = np.abs(PAPz - L @ (U @ Z)).max(axis=0)
    anorm = abs(A).sum(axis=1).max()
    return float((gap / (anorm * np.abs(Z).max(axis=0))).max())


def scaled_residual(A, X, B) -> float:
    """max_j |b_j - A x_j|_inf / (|A|_inf |x_j|_inf + |b_j|_inf)."""
    X, B = np.asarray(X), np.asarray(B)
    work = working(A, X, B)
    A = sp.csr_matrix(A, dtype=work)
    X = np.asarray(X, work).reshape(A.shape[0], -1)
    B = np.asarray(B, work).reshape(A.shape[0], -1)
    anorm = abs(A).sum(axis=1).max()
    r = np.abs(B - A @ X).max(axis=0)
    den = anorm * np.abs(X).max(axis=0) + np.abs(B).max(axis=0)
    return float((r / den).max())


# explicit mantissa bits and the integer type of the same width
_FLOATS = {torch.float32: (23, torch.int32), torch.float64: (52, torch.int64)}


def round_mantissa(x: torch.Tensor, bits: int | None) -> torch.Tensor:
    """float32 or float64 ``x`` rounded to nearest (ties away) at ``bits``
    explicit mantissa bits, each part of a complex ``x`` on its own;
    unchanged when ``bits`` is None."""
    if bits is None:
        return x
    if x.is_complex():
        return torch.view_as_complex(round_mantissa(
            torch.view_as_real(x.resolve_conj()), bits))
    full, ints = _FLOATS[x.dtype]
    drop = full - bits
    i = x.contiguous().view(ints)
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(x.dtype)


def _mm(a, b, bits):
    return round_mantissa(a, bits) @ round_mantissa(b, bits)


def _dense(A, dtype: str) -> torch.Tensor:
    return torch.as_tensor(np.asarray(A), dtype=getattr(torch, dtype)).clone()


def dense_cholesky(A, mantissa: int | None = None, nb: int = 32,
                   dtype: str = "float32"):
    """L (dense, in ``dtype``) with A = L L^H, right-looking by blocks of
    ``nb``; the trailing updates on operands rounded to ``mantissa``
    bits."""
    M = _dense(A, dtype)
    n = M.shape[0]
    for k in range(0, n, nb):
        e = min(k + nb, n)
        M[k:e, k:e] = torch.linalg.cholesky(M[k:e, k:e])
        if e < n:
            # L21 = A21 L11^{-H}
            M[e:, k:e] = torch.linalg.solve_triangular(
                M[k:e, k:e].mH, M[e:, k:e], upper=True, left=False)
            M[e:, e:] -= _mm(M[e:, k:e], M[e:, k:e].mH, mantissa)
    return torch.tril(M)


def dense_lu(A, mantissa: int | None = None, nb: int = 32,
             dtype: str = "float32"):
    """(L unit lower, U upper), dense in ``dtype``, A = L U without
    pivoting or conjugation, right-looking by blocks of ``nb``; the
    trailing updates on operands rounded to ``mantissa`` bits."""
    M = _dense(A, dtype)
    n = M.shape[0]
    for k in range(0, n, nb):
        e = min(k + nb, n)
        for j in range(k, e):                  # unblocked on the block
            M[j + 1:e, j] /= M[j, j]
            M[j + 1:e, j + 1:e] -= torch.outer(M[j + 1:e, j],
                                               M[j, j + 1:e])
        if e < n:
            L11 = torch.tril(M[k:e, k:e], -1) + torch.eye(e - k,
                                                          dtype=M.dtype)
            U11 = torch.triu(M[k:e, k:e])
            M[k:e, e:] = torch.linalg.solve_triangular(
                L11, M[k:e, e:], upper=False, unitriangular=True)
            M[e:, k:e] = torch.linalg.solve_triangular(
                U11, M[e:, k:e], upper=True, left=False)
            M[e:, e:] -= _mm(M[e:, k:e], M[k:e, e:], mantissa)
    return torch.tril(M, -1) + torch.eye(n, dtype=M.dtype), torch.triu(M)
