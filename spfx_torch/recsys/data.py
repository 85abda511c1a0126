"""Interaction data for the ALS/iALS recommender.

A copy of spfx/recsys/data.py (host-only numpy; the port imports nothing of
the JAX package), its logic unchanged.

Host-side preprocessing compiles a ragged user-item interaction matrix into
fixed-shape padded index/value arrays (the recsys analogue of the sparse
planner's padded buckets): per-row item ids padded to a degree cap, with 0
ratings marking padding. Both orientations (by-user for the U update,
by-item for the V update) are materialized.

Includes a MovieLens-format loader (``u.data``-style and ``ratings.csv``
tab/comma files), which reads only a file its caller names, and a
synthetic generator with a power-law degree distribution for tests and
offline benchmarking.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Interactions:
    num_users: int
    num_items: int
    user_ids: np.ndarray    # (nnz,) int32
    item_ids: np.ndarray    # (nnz,) int32
    ratings: np.ndarray     # (nnz,) float32

    @property
    def nnz(self) -> int:
        return len(self.user_ids)

    def split(self, holdout: int = 5, seed: int = 0):
        """Leave-N-out split per user (for recall/NDCG eval)."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(self.nnz)
        u = self.user_ids[order]
        # stable sort by user, random within user
        srt = np.argsort(u, kind="stable")
        u, i, r = u[srt], self.item_ids[order][srt], self.ratings[order][srt]
        starts = np.searchsorted(u, np.arange(self.num_users))
        ends = np.searchsorted(u, np.arange(self.num_users), side="right")
        test_mask = np.zeros(len(u), dtype=bool)
        for uu in range(self.num_users):
            s, e = starts[uu], ends[uu]
            deg = e - s
            if deg >= 2 * holdout:
                test_mask[s:s + holdout] = True
        tr = Interactions(self.num_users, self.num_items,
                          u[~test_mask], i[~test_mask], r[~test_mask])
        te = Interactions(self.num_users, self.num_items,
                          u[test_mask], i[test_mask], r[test_mask])
        return tr, te


def padded_rows(ids_a: np.ndarray, ids_b: np.ndarray, vals: np.ndarray,
                num_a: int, cap: int, pad_rows_to: int = 1):
    """Group (a -> [(b, val)]) and pad to (num_a_padded, cap).

    Returns (idx, val): idx int32 with ``-1`` padding, val f32 with 0 padding.
    Rows beyond num_a (alignment padding for sharding) are all-padding.
    """
    order = np.argsort(ids_a, kind="stable")
    a, b, v = ids_a[order], ids_b[order], vals[order]
    counts = np.bincount(a, minlength=num_a)
    kept = np.minimum(counts, cap)
    na = ((num_a + pad_rows_to - 1) // pad_rows_to) * pad_rows_to
    idx = np.full((na, cap), -1, dtype=np.int32)
    val = np.zeros((na, cap), dtype=np.float32)
    pos_in_row = np.arange(len(a)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    keep = pos_in_row < cap
    idx[a[keep], pos_in_row[keep]] = b[keep]
    val[a[keep], pos_in_row[keep]] = v[keep]
    return idx, val


def load_movielens(path: str) -> Interactions:
    """Load MovieLens ratings: ``u.data`` (tab) or ``ratings.csv`` (comma)."""
    if path.endswith(".csv"):
        raw = np.genfromtxt(path, delimiter=",", skip_header=1,
                            usecols=(0, 1, 2))
    else:
        raw = np.loadtxt(path, usecols=(0, 1, 2))
    users = raw[:, 0].astype(np.int64)
    items = raw[:, 1].astype(np.int64)
    # compact ids
    uu, uinv = np.unique(users, return_inverse=True)
    ii, iinv = np.unique(items, return_inverse=True)
    return Interactions(len(uu), len(ii), uinv.astype(np.int32),
                        iinv.astype(np.int32), raw[:, 2].astype(np.float32))


def synthetic(num_users: int = 2000, num_items: int = 500,
              avg_degree: int = 40, rank: int = 8,
              seed: int = 0) -> Interactions:
    """Synthetic implicit-feedback data with planted low-rank structure and a
    power-law item popularity, so ALS has real signal to recover.

    Vectorised (chunked Gumbel top-k = weighted sampling without
    replacement), so ML-20M-scale generation takes seconds, not minutes.
    """
    rng = np.random.default_rng(seed)
    Ut = (rng.standard_normal((num_users, rank)) / np.sqrt(rank)) \
        .astype(np.float32)
    Vt = (rng.standard_normal((num_items, rank)) / np.sqrt(rank)) \
        .astype(np.float32)
    logpop = -0.4 * np.log(np.arange(1, num_items + 1, dtype=np.float32))
    deg = np.minimum(np.maximum(2, rng.poisson(avg_degree, size=num_users)),
                     num_items // 2)
    us, its = [], []
    chunk = max(1, min(num_users, (1 << 24) // max(1, num_items)))
    dmax_all = int(deg.max())
    for c0 in range(0, num_users, chunk):
        c1 = min(c0 + chunk, num_users)
        logits = 4.0 * (Ut[c0:c1] @ Vt.T) + logpop[None, :]
        g = rng.gumbel(size=logits.shape).astype(np.float32)
        keys = logits + g
        dmax = int(deg[c0:c1].max())
        top = np.argpartition(-keys, dmax - 1, axis=1)[:, :dmax]
        rank_idx = np.arange(dmax)[None, :]
        keep = rank_idx < deg[c0:c1, None]
        uu = np.broadcast_to(np.arange(c0, c1)[:, None], top.shape)
        us.append(uu[keep])
        its.append(top[keep])
    u = np.concatenate(us).astype(np.int32)
    i = np.concatenate(its).astype(np.int32)
    r = np.ones(len(u), dtype=np.float32)
    return Interactions(num_users, num_items, u, i, r)
