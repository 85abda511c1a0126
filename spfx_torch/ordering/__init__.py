"""Fill-reducing orderings (host-side, like the reference's L4 layer).

The reference links SuiteSparse AMD/CAMD and METIS and actively uses METIS
nested dissection (Cholesky/Source/SparseFrame.c:864-954, parameter.h:23).
spfx has no external ordering libraries; it ships its own:

- ``nested_dissection``: George-Liu style BFS-separator ND (the reference's
  active method class) — ``spfx.ordering.nd``
- ``amd``: approximate minimum degree (quotient-graph) — native C++ with a
  Python fallback of minimum-degree semantics — ``spfx.ordering.amd``
- ``camd``: constrained minimum degree (ref SparseFrame_camd :777-862;
  class-ordered elimination) — ``spfx.ordering.camd`` (function API: takes
  the per-vertex constraint vector)
- ``rcm``: reverse Cuthill-McKee via scipy.csgraph (band-reducing baseline)
- ``identity``: no permutation (ref PERM_IDENTITY, type.h:53)

``order(A, method)`` returns perm such that P A P^T with P[i,j]=1 at
(i, perm[i]) — i.e. new_index = inv_perm[old_index]; column k of the permuted
matrix is column perm[k] of A (SuiteSparse convention).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .nd import nested_dissection
from .amd import amd
from .camd import camd


def order(A: sp.spmatrix, method: str = "auto") -> np.ndarray:
    """Compute a fill-reducing ordering of the symmetric pattern of A."""
    A = sp.csc_matrix(A)
    n = A.shape[0]
    if method == "auto":
        method = "amd" if n < 5000 else "nd"
    if method == "identity":
        return np.arange(n, dtype=np.int64)
    if method == "rcm":
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        S = ((A != 0) + (A != 0).T).tocsr()
        return reverse_cuthill_mckee(S, symmetric_mode=True).astype(np.int64)
    if method == "nd":
        return nested_dissection(A)
    if method == "amd":
        return amd(A)
    if method == "camd":
        # default constraint vector: every vertex in class 0, i.e. plain
        # minimum degree through the constrained code path (callers with real
        # constraints use spfx.ordering.camd directly — ref camd_l2 semantics,
        # Cholesky/Source/SparseFrame.c:777-862)
        return camd(A, np.zeros(n, dtype=np.int64))
    raise ValueError(f"unknown ordering method {method!r}")
