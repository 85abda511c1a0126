"""(Approximate) minimum-degree ordering.

The reference calls SuiteSparse ``amd_l2`` (Cholesky/Source/
SparseFrame.c:693-775, knobs parameter.h:25-26). spfx implements minimum
degree natively: the C++ planner carries a quotient-graph AMD
(spfx/cpp/planner.cpp); this module provides the Python fallback — an exact
external-degree minimum-degree elimination, quadratic-ish but only used for
small graphs (ND leaf subproblems and small whole matrices).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from spfx_torch.symbolic import _native


def _md_python(S: sp.csr_matrix) -> np.ndarray:
    """Exact minimum (external) degree by clique elimination on sets."""
    n = S.shape[0]
    adj = [set(S.indices[S.indptr[i]:S.indptr[i + 1]].tolist()) - {i}
           for i in range(n)]
    alive = np.ones(n, dtype=bool)
    deg = np.array([len(a) for a in adj], dtype=np.int64)
    perm = np.empty(n, dtype=np.int64)
    for k in range(n):
        # pick min-degree alive vertex (ties -> smallest index: deterministic)
        cand = np.where(alive)[0]
        v = cand[np.argmin(deg[cand])]
        perm[k] = v
        alive[v] = False
        nbrs = [u for u in adj[v] if alive[u]]
        for u in nbrs:
            adj[u].discard(v)
            adj[u].update(w for w in nbrs if w != u)
            deg[u] = len([w for w in adj[u] if alive[w]])
        adj[v] = set()
    return perm


def amd_dense_tail(S: sp.spmatrix) -> np.ndarray:
    """Order a small subgraph by minimum degree (used for ND leaves)."""
    S = sp.csr_matrix(S)
    n = S.shape[0]
    if n <= 1:
        return np.arange(n, dtype=np.int64)
    if _native.available():
        Sc = sp.csc_matrix(S)
        p = _native.amd(n, Sc.indptr, Sc.indices)
        if p is not None:
            return p
    return _md_python(S)


def amd(A: sp.spmatrix) -> np.ndarray:
    """Minimum-degree permutation of the symmetric pattern of A."""
    A = sp.csc_matrix(A)
    n = A.shape[0]
    S = ((A != 0) + (A != 0).T)
    S.setdiag(0)
    S.eliminate_zeros()
    if _native.available():
        Sc = sp.csc_matrix(S)
        p = _native.amd(n, Sc.indptr, Sc.indices)
        if p is not None:
            return p
    if n > 3000:
        # python MD is too slow at this size; ND has the right asymptotics
        from .nd import nested_dissection
        return nested_dissection(A)
    return _md_python(sp.csr_matrix(S))
