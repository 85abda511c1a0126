"""Elimination tree + postorder + column counts (host symbolic layer).

TPU-era re-design of the reference symbolic components:
- ``etree``      ~ SparseFrame_etree  (Cholesky/Source/SparseFrame.c:1068-1127)
  Liu's path-compression algorithm on the lower-triangular pattern. For the LU
  line the caller passes the symmetrised pattern of A+A^T, matching the
  reference's union over L and U patterns (LU/Source/SparseFrame.c:1360-1386).
- ``postorder``  ~ SparseFrame_postorder (:1129-1236) — iterative DFS with
  children optionally ordered by subtree weight.
- ``col_counts`` ~ SparseFrame_colcount (:1238-1352). The reference uses the
  Gilbert–Ng–Peyton skeleton algorithm (O(nnz·alpha)); spfx instead uses the
  row-subtree traversal, which is O(nnz(L)) — the same asymptotic cost as the
  supernodal pattern construction we need anyway, and far simpler. Both yield
  exact per-column factor counts.

These are pure-Python/numpy reference implementations; `spfx.cpp` carries the
C++ fast path with identical semantics (cross-validated in tests).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import _native


def _lower_csc(A: sp.spmatrix) -> sp.csc_matrix:
    """Strictly-lower-triangular pattern of A (values discarded)."""
    A = sp.csc_matrix(A)
    return sp.tril(A, k=-1, format="csc")


def etree(A: sp.spmatrix) -> np.ndarray:
    """Elimination tree of the (symmetric-pattern) matrix A.

    Returns parent[j] (int64), -1 for roots. Pattern-symmetric input assumed;
    only the upper triangle (columns' rows above the diagonal) is walked, i.e.
    for each column j we visit rows i < j of column j — equivalently entries
    of row j of the lower triangle.
    """
    A = sp.csc_matrix(A)
    n = A.shape[0]
    if _native.available():
        return _native.etree(n, A.indptr, A.indices)
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    indptr, indices = A.indptr, A.indices
    for j in range(n):
        for p in range(indptr[j], indptr[j + 1]):
            i = indices[p]
            if i >= j:
                continue
            # walk from i to the root of its current subtree, compressing
            r = i
            while True:
                a = ancestor[r]
                if a == j:
                    break
                ancestor[r] = j
                if a == -1:
                    parent[r] = j
                    break
                r = a
    return parent


def postorder(parent: np.ndarray, weight: np.ndarray | None = None) -> np.ndarray:
    """Postorder permutation of the forest given by ``parent``.

    Returns ``post`` with post[k] = the k-th node in postorder. Children are
    visited in ascending ``weight`` order when given (the reference orders by
    ColCount on its second pass, :1129-1236) so heavier subtrees finish last.
    """
    n = len(parent)
    # build child lists (reverse order so DFS pops ascending)
    order = np.argsort(weight, kind="stable") if weight is not None \
        else np.arange(n)
    head = np.full(n, -1, dtype=np.int64)
    next_ = np.full(n, -1, dtype=np.int64)
    roots = []
    for j in order[::-1]:
        p = parent[j]
        if p == -1:
            roots.append(j)
        else:
            next_[j] = head[p]
            head[p] = j
    post = np.empty(n, dtype=np.int64)
    k = 0
    stack = np.empty(n, dtype=np.int64)
    for r in roots[::-1]:
        top = 0
        stack[0] = r
        while top >= 0:
            j = stack[top]
            c = head[j]
            if c == -1:
                post[k] = j
                k += 1
                top -= 1
            else:
                head[j] = next_[c]
                top += 1
                stack[top] = c
    assert k == n
    return post


def col_counts(A: sp.spmatrix, parent: np.ndarray) -> np.ndarray:
    """nnz of each column of the Cholesky factor L (including the diagonal).

    Row-subtree method: the nonzeros of row i of L are exactly the nodes on
    the etree paths from each j (A[i,j] != 0, j < i) up toward i. Each visited
    node contributes one to its column count. O(nnz(L)).
    """
    A = sp.csc_matrix(A)
    n = A.shape[0]
    if _native.available():
        return _native.col_counts(n, A.indptr, A.indices, parent)
    counts = np.ones(n, dtype=np.int64)          # diagonal
    mark = np.full(n, -1, dtype=np.int64)
    indptr, indices = A.indptr, A.indices
    for i in range(n):
        mark[i] = i
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            if j >= i:
                continue
            while mark[j] != i:
                mark[j] = i
                counts[j] += 1
                j = parent[j]
                if j == -1:
                    break
    return counts


def etree_levels(parent: np.ndarray) -> np.ndarray:
    """Height of each node above its deepest leaf: leaves have level 0 and
    level[p] > level[c] for every child c. This is the static analogue of the
    reference's dynamic leaf queue (SparseFrame.c:2300-2306, 2962-2986): all
    nodes of one level are mutually independent and can factor concurrently.
    """
    n = len(parent)
    level = np.zeros(n, dtype=np.int64)
    # nodes must be processed children-before-parents; etree parents have
    # larger indices, so ascending index order works.
    for j in range(n):
        p = parent[j]
        if p != -1 and level[p] <= level[j]:
            level[p] = level[j] + 1
    return level
