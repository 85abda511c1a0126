"""Supernode formation: fundamental splitting + relaxed amalgamation +
supernodal row patterns.

TPU-era re-design of the reference's supernodal planner
``SparseFrame_analyze_supernodal`` (Cholesky/Source/SparseFrame.c:1354-1914):
  (b) fundamental supernode split (:1474-1502)  -> ``fundamental_supernodes``
  (c) relaxed amalgamation ``should_relax`` (:1524-1625, parameter.h:28-46)
      -> ``amalgamate``
  (d) supernodal row pattern Lsi (:1629-1692)   -> ``sn_patterns``

The reference's stage partition (:1721-1846) and leaf queue (:1848-1873)
become a *static level schedule* computed in ``spfx.plan.schedule``: on TPU
there is no dynamic work-stealing — the planner compiles the elimination tree
into levels of mutually independent supernodes executed as batched kernels.

Amalgamation bookkeeping exploits the chain invariant: when child supernode c
(width wc) merges into its adjacent parent supernode p (width wp, pattern row
count rp), the merged pattern has exactly wc + rp rows, because the rows of c
beyond its own columns are always a subset of p's pattern (path containment
along the elimination tree). Explicit-zero accounting is therefore exact
without touching the patterns.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from spfx_torch.utils.config import Config, DEFAULT
from . import _native


def fundamental_supernodes(parent: np.ndarray, counts: np.ndarray,
                           max_cols: int = 10**9) -> np.ndarray:
    """Split columns into fundamental supernodes.

    Column j joins the supernode of j-1 iff parent[j-1] == j and
    counts[j-1] == counts[j] + 1 (identical below-diagonal structure), and the
    width cap is not exceeded (the reference caps by device slot size,
    :1474-1502; spfx caps by config.max_sn_cols).

    Returns sn_start: int64 array of length nsuper+1 (column ranges).
    """
    n = len(parent)
    starts = [0]
    width = 1
    for j in range(1, n):
        if parent[j - 1] == j and counts[j - 1] == counts[j] + 1 \
                and width < max_cols:
            width += 1
        else:
            starts.append(j)
            width = 1
    starts.append(n)
    return np.asarray(starts, dtype=np.int64)


def amalgamate(sn_start: np.ndarray, parent: np.ndarray, counts: np.ndarray,
               config: Config = DEFAULT) -> np.ndarray:
    """Relaxed amalgamation over adjacent parent/child supernodes.

    Mirrors the reference's should_relax policy (parameter.h:28-46): merge the
    supernode starting at column b into the one ending at b when the merged
    width stays under a threshold tier and the explicit-zero fraction of the
    merged trapezoid stays below that tier's fill allowance.

    Works right-to-left over fundamental supernodes so a chain of small
    leaves collapses into its ancestor greedily (like the reference's
    bottom-up merge loop :1524-1625).
    """
    nf = len(sn_start) - 1
    # per-group stats, indexed by the group's first fundamental supernode
    g_width = (sn_start[1:] - sn_start[:-1]).astype(np.int64)
    first_col = sn_start[:-1]
    last_col = sn_start[1:] - 1
    # pattern row count of a fundamental supernode == counts[first_col]:
    # the first column's structure already contains the member columns and
    # every beyond-row (identical below-diagonal structure is what made the
    # columns one supernode)
    g_rows = counts[first_col].astype(np.int64).copy()
    g_nz = np.zeros(nf, dtype=np.float64)     # true nonzeros in trapezoid
    for s in range(nf):
        c = counts[first_col[s]:last_col[s] + 1].sum()
        g_nz[s] = float(c)
    # group-of map: group containing fundamental sn s starts at g_start_of[s]
    g_start_of = np.arange(nf, dtype=np.int64)
    merged_right = np.zeros(nf, dtype=bool)   # True if group s+... absorbed

    tiers = list(zip(config.relax_width, config.relax_fill))

    def should_relax(w: int, zfrac: float) -> bool:
        for tw, tf in tiers:
            if w <= tw:
                return zfrac <= tf
        return False

    for s in range(nf - 2, -1, -1):
        right = s + 1
        if merged_right[right]:
            continue  # group at s+1 no longer exists (absorbed rightward? no)
        # parent supernode of s must be exactly the group starting at s+1
        pcol = parent[last_col[s]]
        if pcol == -1:
            continue
        # group of pcol: find its start. pcol belongs to the fundamental
        # supernode f with sn_start[f] <= pcol < sn_start[f+1].
        f = int(np.searchsorted(sn_start, pcol, side="right") - 1)
        if g_start_of[f] != right:
            continue
        wc, wp = int(g_width[s]), int(g_width[right])
        rp = int(g_rows[right])
        w_new = wc + wp
        if w_new > config.max_sn_cols:
            continue
        r_new = wc + rp
        trap = r_new * w_new - w_new * (w_new - 1) // 2
        nz_new = g_nz[s] + g_nz[right]
        zfrac = 1.0 - nz_new / trap
        if not should_relax(w_new, zfrac):
            continue
        # merge group(right..) into group starting at s
        g_width[s] = w_new
        g_rows[s] = r_new
        g_nz[s] = nz_new
        # every fundamental sn in the old right group now belongs to s's group
        end = right
        while end + 1 < nf and g_start_of[end + 1] == right:
            end += 1
        g_start_of[right:end + 1] = s
        merged_right[right] = True

    starts = [0]
    for s in range(nf):
        if g_start_of[s] == s and s > 0:
            starts.append(int(sn_start[s]))
    starts.append(int(sn_start[-1]))
    return np.asarray(sorted(set(starts + [0, int(sn_start[-1])])),
                      dtype=np.int64)


def sn_of_map(sn_start: np.ndarray, n: int) -> np.ndarray:
    """Column -> supernode index map."""
    nsuper = len(sn_start) - 1
    sn_of = np.zeros(n, dtype=np.int64)
    for s in range(nsuper):
        sn_of[sn_start[s]:sn_start[s + 1]] = s
    return sn_of


def sn_patterns(A: sp.csc_matrix, parent: np.ndarray, sn_start: np.ndarray,
                sn_of: np.ndarray):
    """Row pattern of each supernode (union of member columns' exact factor
    patterns), sorted ascending. Ref: supernodal pattern Lsi (:1629-1692).

    Returns (sn_ptr, sn_rows): CSR-like. Row-subtree traversal, O(nnz(L)).
    """
    A = sp.csc_matrix(A)
    n = A.shape[0]
    nsuper = len(sn_start) - 1
    indptr, indices = A.indptr, A.indices
    if _native.available():
        return _native.sn_pattern(n, indptr, indices, parent, sn_of, nsuper)
    mark = np.full(n, -1, dtype=np.int64)
    sn_stamp = np.full(nsuper, -1, dtype=np.int64)
    rows = [[] for _ in range(nsuper)]
    for i in range(n):
        mark[i] = i
        si = sn_of[i]
        sn_stamp[si] = i
        rows[si].append(i)
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            if j >= i:
                continue
            while mark[j] != i:
                mark[j] = i
                s = sn_of[j]
                if sn_stamp[s] != i:
                    sn_stamp[s] = i
                    rows[s].append(i)
                j = parent[j]
                if j == -1:
                    break
    sn_ptr = np.zeros(nsuper + 1, dtype=np.int64)
    for s in range(nsuper):
        sn_ptr[s + 1] = sn_ptr[s] + len(rows[s])
    sn_rows = np.concatenate([np.asarray(r, dtype=np.int64) for r in rows]) \
        if nsuper else np.zeros(0, dtype=np.int64)
    return sn_ptr, sn_rows
