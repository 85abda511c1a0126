"""Synthetic test/bench matrices.

The reference ships no fixtures (users drop SuiteSparse ``*.mtx`` files,
.gitignore:7).  spfx generates SuiteSparse-class problems on the fly:
structured-grid Laplacians (the canonical sparse-direct benchmark family) and
random SPD / diagonally-dominant unsymmetric matrices for property tests.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def laplacian_1d(n: int) -> sp.csc_matrix:
    d = 2.0 * np.ones(n)
    e = -np.ones(n - 1)
    return sp.diags([e, d, e], [-1, 0, 1], format="csc")


def laplacian_2d(nx: int, ny: int | None = None) -> sp.csc_matrix:
    """5-point 2D Poisson operator, SPD, n = nx*ny."""
    ny = ny or nx
    Ix, Iy = sp.identity(nx), sp.identity(ny)
    A = sp.kron(Iy, laplacian_1d(nx)) + sp.kron(laplacian_1d(ny), Ix)
    return sp.csc_matrix(A) + 1e-2 * sp.identity(nx * ny, format="csc")


def laplacian_3d(nx: int, ny: int | None = None, nz: int | None = None) -> sp.csc_matrix:
    """7-point 3D Poisson operator, SPD, n = nx*ny*nz."""
    ny = ny or nx
    nz = nz or nx
    Ix, Iy, Iz = sp.identity(nx), sp.identity(ny), sp.identity(nz)
    A = (sp.kron(Iz, sp.kron(Iy, laplacian_1d(nx)))
         + sp.kron(Iz, sp.kron(laplacian_1d(ny), Ix))
         + sp.kron(laplacian_1d(nz), sp.kron(Iy, Ix)))
    return sp.csc_matrix(A) + 1e-2 * sp.identity(nx * ny * nz, format="csc")


def random_spd(n: int, density: float = 0.02, seed: int = 0) -> sp.csc_matrix:
    """Random sparse SPD: A = B + B^T + shift*I with B random sparse."""
    rng = np.random.default_rng(seed)
    B = sp.random(n, n, density=density, random_state=rng, format="csc")
    A = B + B.T
    # diagonal dominance => SPD
    rowsum = np.abs(A).sum(axis=1).A1 if hasattr(np.abs(A).sum(axis=1), "A1") \
        else np.asarray(np.abs(A).sum(axis=1)).ravel()
    A = A + sp.diags(rowsum + 1.0)
    return sp.csc_matrix(A)


def random_unsym(n: int, density: float = 0.02, seed: int = 0,
                 symmetric_pattern: bool = False) -> sp.csc_matrix:
    """Random sparse diagonally-dominant unsymmetric matrix.

    Diagonal dominance makes no-pivot LU stable, matching the reference's
    strictly pivot-free getrf (LU/Source/SparseFrame.c:3344 NULL ipiv).
    """
    rng = np.random.default_rng(seed)
    B = sp.random(n, n, density=density, random_state=rng, format="csc")
    if symmetric_pattern:
        # same pattern both triangles, different values
        C = sp.csc_matrix((rng.standard_normal(B.nnz), B.indices.copy(),
                           B.indptr.copy()), shape=B.shape)
        B = B + C.T
    rowsum = np.asarray(np.abs(B).sum(axis=1)).ravel()
    colsum = np.asarray(np.abs(B).sum(axis=0)).ravel()
    A = B + sp.diags(rowsum + colsum + 1.0)
    return sp.csc_matrix(A)


def random_hermitian(n: int, density: float = 0.05,
                     seed: int = 0) -> sp.csc_matrix:
    """Random sparse Hermitian positive-definite matrix (complex), for the
    zpotrf/zherk line of the reference."""
    rng = np.random.default_rng(seed)
    B = sp.random(n, n, density=density, random_state=rng, format="csc")
    C = sp.csc_matrix((B.data * np.exp(2j * np.pi * rng.random(B.nnz)),
                       B.indices.copy(), B.indptr.copy()), shape=B.shape)
    H = C + C.conj().T
    rowsum = np.asarray(np.abs(H).sum(axis=1)).ravel()
    return sp.csc_matrix(H + sp.diags(rowsum + 1.0))


def random_unsym_complex(n: int, density: float = 0.05, seed: int = 0
                         ) -> sp.csc_matrix:
    """Random sparse diagonally-dominant complex unsymmetric matrix, for
    the zgetrf_nopiv line of the reference (LU/Source/SparseFrame.c:2652)."""
    rng = np.random.default_rng(seed)
    B = sp.random(n, n, density=density, random_state=rng, format="csc")
    B = sp.csc_matrix((B.data * np.exp(2j * np.pi * rng.random(B.nnz)),
                       B.indices.copy(), B.indptr.copy()), shape=B.shape)
    rowsum = np.asarray(np.abs(B).sum(axis=1)).ravel()
    colsum = np.asarray(np.abs(B).sum(axis=0)).ravel()
    return sp.csc_matrix(B + sp.diags(rowsum + colsum + 1.0))


def stretched_grid(nx: int, ny: int, aniso: float = 100.0) -> sp.csc_matrix:
    """Anisotropic 2D operator — produces long thin supernodes, a harder
    shape mix for the bucketed batched kernels."""
    Ix, Iy = sp.identity(nx), sp.identity(ny)
    A = sp.kron(Iy, laplacian_1d(nx)) + aniso * sp.kron(laplacian_1d(ny), Ix)
    return sp.csc_matrix(A) + 1e-2 * sp.identity(nx * ny, format="csc")
