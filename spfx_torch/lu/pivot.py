"""Static pivoting: greedy max-magnitude row matching.

The reference ships this capability as ``SparseFrame_pivot``
(LU/Source/SparseFrame.c:589-673) but leaves the call site disabled
(``#if 0`` at :784-787) — its shipped LU is strictly no-pivot.  spfx keeps
the same no-pivot numeric engine (that is what makes the static TPU schedule
possible) and offers the pivot as an *optional host-side preprocessing* step
(SURVEY §7 "hard parts"): a row permutation computed once from the values
that moves a large entry of each column onto the diagonal before the
symbolic analysis.  Enabled with ``Config(static_pivot=True)``.

Semantics match the reference routine: columns are scanned in order; each
column claims the not-yet-matched row holding its largest-magnitude entry
(:623-655).  Rows left unmatched are assigned to the remaining columns to
complete the permutation (the reference leaves them in place, which is only
a partial relabeling; a direct solver needs a full permutation).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def static_pivot(A: sp.spmatrix) -> np.ndarray:
    """Row permutation ``rperm`` such that ``A[rperm, :]`` has a
    strengthened diagonal: ``rperm[j]`` is the row moved into position j.

    Greedy max-magnitude matching per column (ref :623-655), completed to a
    full permutation for unmatched rows/columns.
    """
    A = sp.csc_matrix(A)
    n, m = A.shape
    if n != m:
        raise ValueError("static_pivot needs a square matrix")
    Ap, Ai = A.indptr, A.indices
    Av = np.abs(A.data)
    matched = np.zeros(n, dtype=bool)
    rperm = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        lo, hi = Ap[j], Ap[j + 1]
        if lo == hi:
            continue
        rows = Ai[lo:hi]
        vals = np.where(matched[rows], -1.0, Av[lo:hi])
        k = int(np.argmax(vals))
        if vals[k] >= 0.0:
            rperm[j] = rows[k]
            matched[rows[k]] = True
    unmatched_cols = np.flatnonzero(rperm < 0)
    if unmatched_cols.size:
        rperm[unmatched_cols] = np.flatnonzero(~matched)
    return rperm


def diag_dominance(A: sp.spmatrix) -> float:
    """min_j |A[j,j]| / max_i |A[i,j]| — 1.0 means every diagonal entry is
    the largest in its column; used by tests to confirm the pivot helps."""
    A = sp.csc_matrix(A)
    d = np.abs(A.diagonal())
    colmax = np.abs(A).max(axis=0).toarray().ravel()
    colmax = np.where(colmax == 0, 1.0, colmax)
    return float(np.min(d / colmax))
