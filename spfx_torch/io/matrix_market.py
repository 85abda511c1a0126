"""MatrixMarket I/O and triplet -> CSC compression.

TPU-era re-implementation of the reference reader/compressor:
- ``read_triplet``  ~ SparseFrame_read_matrix_triplet
  (Cholesky/Source/SparseFrame.c:400-524): parses the banner
  (matrix coordinate real|complex|integer|pattern general|symmetric), drops
  explicit zeros, converts 1-based -> 0-based.
- ``triplet_to_csc`` ~ SparseFrame_compress (:526-587): counting sort into
  (Cp, Ci, Cx).
- ``read_matrix`` ~ SparseFrame_read_matrix (:652-691) orchestrates both and
  returns a scipy CSC matrix (host-side symbolic analysis uses scipy/numpy —
  the device never sees sparse formats; the planner compiles them away).

Unlike the reference (C line-by-line fgets parse) this is vectorised numpy.
"""

from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass
class Triplet:
    nrow: int
    ncol: int
    row: np.ndarray          # int64, 0-based
    col: np.ndarray          # int64, 0-based
    val: np.ndarray          # float64 or complex128
    is_symmetric: bool       # file stored lower triangle only
    is_complex: bool


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_triplet(path) -> Triplet:
    """Parse a MatrixMarket coordinate file (ref reader :400-524)."""
    with _open(path) as f:
        banner = f.readline().strip().lower().split()
        if len(banner) < 5 or banner[0] != "%%matrixmarket" or banner[1] != "matrix":
            raise ValueError(f"not a MatrixMarket matrix file: {path}")
        fmt, field, symm = banner[2], banner[3], banner[4]
        if fmt != "coordinate":
            raise ValueError("only coordinate format supported (like the reference)")
        if field not in ("real", "complex", "integer", "pattern"):
            raise ValueError(f"unsupported field {field}")
        if symm not in ("general", "symmetric", "skew-symmetric", "hermitian"):
            raise ValueError(f"unsupported symmetry {symm}")
        # skip comments
        line = f.readline()
        while line.startswith("%") or line.strip() == "":
            line = f.readline()
        nrow, ncol, nnz = (int(t) for t in line.split())
        body = f.read()

    data = np.loadtxt(_io.StringIO(body), ndmin=2) if nnz > 0 else np.zeros((0, 2))
    if data.shape[0] != nnz:
        raise ValueError(f"expected {nnz} entries, got {data.shape[0]}")
    row = data[:, 0].astype(np.int64) - 1
    col = data[:, 1].astype(np.int64) - 1
    is_complex = field == "complex"
    if field == "pattern":
        val = np.ones(nnz, dtype=np.float64)
    elif is_complex:
        val = data[:, 2] + 1j * data[:, 3]
    else:
        val = data[:, 2].astype(np.float64)
    # drop explicit zeros (ref :496)
    keep = val != 0
    row, col, val = row[keep], col[keep], val[keep]
    if symm == "skew-symmetric":
        # expand now; we do not track skewness downstream
        m = row != col
        row = np.concatenate([row, col[m]])
        col = np.concatenate([col, row[: len(val)][m]])
        val = np.concatenate([val, -val[m]])
        symm = "general"
    return Triplet(nrow, ncol, row, col, val,
                   is_symmetric=symm in ("symmetric", "hermitian"),
                   is_complex=is_complex)


def triplet_to_csc(t: Triplet, expand_symmetric: bool = False) -> sp.csc_matrix:
    """Counting-sort triplets into CSC (ref compress :526-587).

    If ``expand_symmetric`` and the file stored only one triangle, mirror it.
    """
    row, col, val = t.row, t.col, t.val
    if expand_symmetric and t.is_symmetric:
        m = row != col
        r2 = np.concatenate([row, col[m]])
        c2 = np.concatenate([col, row[m]])
        v2 = np.concatenate([val, np.conj(val[m]) if t.is_complex else val[m]])
        row, col, val = r2, c2, v2
    A = sp.csc_matrix((val, (row, col)), shape=(t.nrow, t.ncol))
    A.sum_duplicates()
    return A


def read_matrix(path, expand_symmetric: bool = True) -> sp.csc_matrix:
    """Read a .mtx file into CSC (ref read_matrix :652-691)."""
    t = read_triplet(path)
    return triplet_to_csc(t, expand_symmetric=expand_symmetric)


def write_matrix(path, A: sp.spmatrix, symmetric: bool = False) -> None:
    """Write CSC/COO to MatrixMarket coordinate format (test fixture helper)."""
    A = sp.coo_matrix(A)
    if symmetric:
        keep = A.row >= A.col
        A = sp.coo_matrix((A.data[keep], (A.row[keep], A.col[keep])), shape=A.shape)
    with open(path, "w") as f:
        kind = "complex" if np.iscomplexobj(A.data) else "real"
        sym = "symmetric" if symmetric else "general"
        f.write(f"%%MatrixMarket matrix coordinate {kind} {sym}\n")
        f.write(f"{A.shape[0]} {A.shape[1]} {A.nnz}\n")
        if kind == "complex":
            for r, c, v in zip(A.row, A.col, A.data):
                f.write(f"{r + 1} {c + 1} {v.real:.17g} {v.imag:.17g}\n")
        else:
            for r, c, v in zip(A.row, A.col, A.data):
                f.write(f"{r + 1} {c + 1} {v:.17g}\n")
