"""Constrained minimum-degree ordering (CAMD).

The reference links SuiteSparse CAMD and carries a (commented-out) call site
``SparseFrame_camd`` (Cholesky/Source/SparseFrame.c:777-862): minimum-degree
elimination where every vertex carries a constraint class and the output
permutation must order class 0 entirely before class 1, etc. The classic use
is ordering within nested-dissection separatrix structure: leaves get low
classes, separators high, so separator columns eliminate last.

spfx implements the same semantics natively: exact external-degree minimum
degree (clique elimination), with vertex selection restricted to the lowest
nonempty alive constraint class. Matches ``amd`` output quality when all
constraints are equal.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def camd(A: sp.spmatrix, constraints: np.ndarray) -> np.ndarray:
    """Constrained minimum-degree permutation of the symmetric pattern of A.

    constraints: (n,) integer class per vertex; all vertices of class c are
    ordered before any vertex of class c' > c (ref camd_l2 semantics).
    Returns perm such that A[perm][:, perm] has the constrained MD order.
    """
    A = sp.csc_matrix(A)
    n = A.shape[0]
    C = np.asarray(constraints, dtype=np.int64)
    if C.shape != (n,):
        raise ValueError(f"constraints must be ({n},), got {C.shape}")
    S = ((A != 0) + (A != 0).T)
    S.setdiag(0)
    S.eliminate_zeros()
    S = sp.csr_matrix(S)
    # fast path: the C++ quotient-graph constrained AMD (supervariable
    # hashing + element absorption, spfx/cpp/planner.cpp) — scales to
    # n ~ 10^6; this file's exact O(n^2)-ish set-based elimination remains
    # as the oracle fallback and ground truth for tests
    from spfx_torch.symbolic import _native
    if _native.available():
        p = _native.camd(n, S.indptr.astype(np.int64), S.indices, C)
        if p is not None:
            return p

    adj = [set(S.indices[S.indptr[i]:S.indptr[i + 1]].tolist())
           for i in range(n)]
    alive = np.ones(n, dtype=bool)
    deg = np.array([len(a) for a in adj], dtype=np.int64)
    perm = np.empty(n, dtype=np.int64)
    # process constraint classes in ascending order; within a class, plain
    # minimum external degree (ties -> smallest index: deterministic)
    order_of_class = np.argsort(C, kind="stable")
    class_sorted = C[order_of_class]
    k = 0
    for cls in np.unique(C):
        lo = np.searchsorted(class_sorted, cls)
        hi = np.searchsorted(class_sorted, cls, side="right")
        members = order_of_class[lo:hi]
        for _ in range(hi - lo):
            live = members[alive[members]]
            v = live[np.argmin(deg[live])]
            perm[k] = v
            k += 1
            alive[v] = False
            nbrs = [u for u in adj[v] if alive[u]]
            for u in nbrs:
                adj[u].discard(v)
                adj[u].update(w for w in nbrs if w != u)
                deg[u] = sum(1 for w in adj[u] if alive[w])
            adj[v] = set()
    return perm
