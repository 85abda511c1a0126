"""ALS / iALS matrix-factorization recommender on batched Cholesky solves.

Port of spfx/recsys/als.py. Each half-iteration solves one k x k
regularized normal equation per user (then per item) with the batched
Cholesky solve of ``spfx_torch.kernels.dense``; the shared Gramian
G = Y^T Y is formed once per sweep.

Implicit ALS (Hu-Koren-Volinsky): minimize
  sum_ui c_ui (p_ui - u_u . v_i)^2 + lam (|U|^2 + |V|^2),
  c_ui = 1 + alpha r_ui, p_ui = [r_ui > 0],
with the Gramian trick A_u = V^T V + V_u^T diag(c-1) V_u + lam I.
Explicit ALS: alternating ridge regression on observed entries.

All shapes are static: interactions are degree-capped padded index arrays
(``spfx_torch.recsys.data.padded_rows``) and the rows are solved in
``config.chunk``-row pieces, as the JAX package's ``lax.map`` does. The
JAX sweep is one ``shard_map`` program over a row-sharded mesh; the port's
mesh is one device (``spfx_torch.dist.mesh``), so the sweep is a loop over
its one shard. Tables are padded to ``round_up(n, chunk * ndev)`` rows
like JAX's, and the padding rows stay zero.

Precision: every sweep runs inside ``mega.matmul_precision(
config.matmul_precision)``: "highest" (the default) is full float32 with
TF32 off, "high" sends the float32 Gram products to ``bmm_bf16x3``.
``topk``'s score product lies outside any precision context in the JAX
package, so it runs at JAX's default precision, which the port maps to
TF32 on the card (``mega._PRECISION``); on the CPU it stays full float32,
as JAX's CPU default does.

``fit_steps(iters)`` waits for nothing on the host: on the card one
iteration (both sweeps) is captured into a CUDA graph at the first call
and replayed ``iters`` times, as ``MegaRunner`` replays a factorization
(the JAX package makes it one program with a traced iteration count).
Every call of the sweep can be captured: the gathers, the products,
``cholesky_ex(check_errors=False)`` and the triangular solves.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from spfx_torch.dist.mesh import Mesh, make_mesh, round_up
from spfx_torch.kernels import matmul
from spfx_torch.kernels.dense import batched_chol_solve
from .data import Interactions, padded_rows


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    rank: int = 64
    lam: float = 0.1            # L2 regularization
    alpha: float = 10.0         # implicit confidence weight
    implicit: bool = True
    iters: int = 10
    user_cap: int = 256         # degree cap (padded row width), users
    item_cap: int = 512         # degree cap, items
    chunk: int = 1024           # rows per chunk per device
    dtype: str = "float32"
    matmul_precision: str = "highest"   # JAX precision name (see Config)
    seed: int = 0


def _solve_rows(Yz, G, idx, rat, lam, alpha, implicit: bool):
    """Normal-equation solve for one chunk of rows.

    Yz: (m+1, k) read-side table with a zero sentinel row at index m
    G:  (k, k) shared Gramian Y^T Y (zero on the explicit path)
    idx/rat: (C, D) padded neighbor ids (-1 pad) and ratings (0 pad)
    """
    k = Yz.shape[1]
    m = Yz.shape[0] - 1
    live = idx >= 0
    Yg = Yz[torch.where(live, idx, m)]             # (C, D, k)
    mask = live.to(Yg.dtype)
    if implicit:
        cm1 = alpha * rat                          # c - 1; 0 on padding
        A = G[None] + matmul.bmm((Yg * cm1[..., None]).transpose(1, 2), Yg)
        w = (1.0 + cm1) * mask
    else:
        A = matmul.bmm((Yg * mask[..., None]).transpose(1, 2), Yg)
        w = rat * mask
    b = matmul.bmm(Yg.transpose(1, 2), w[..., None])          # (C, k, 1)
    A = A + lam * torch.eye(k, dtype=Yg.dtype, device=Yg.device)[None]
    return batched_chol_solve(A, b)[..., 0]


def make_sweep(mesh: Mesh, implicit: bool, chunk: int):
    """The sweep (Yother, idx, rat, lam, alpha) -> Xnew over the mesh's one
    device: the rows in ``chunk``-row pieces (JAX: ``lax.map`` over each
    shard), against the read-side table with its zero sentinel row and the
    Gramian over the full table, formed once per sweep."""

    def sweep(Yother, idx, rat, lam, alpha):
        n, k = idx.shape[0], Yother.shape[1]
        # padded and sentinel rows are zero, so they add nothing to G
        if implicit:
            G = matmul.bmm(Yother.t()[None], Yother[None])[0]
        else:
            G = Yother.new_zeros((k, k))
        Yz = torch.cat([Yother, Yother.new_zeros((1, k))])
        nch = max(1, n // chunk)
        step = n // nch
        return torch.cat([
            _solve_rows(Yz, G, idx[c0:c0 + step], rat[c0:c0 + step], lam,
                        alpha, implicit)
            for c0 in range(0, n, step)])

    return sweep


class _FitSteps:
    """``iters`` full iterations (users, then items) with no host wait, in
    place on copies of U and V. On the CPU the loop runs eagerly; on the
    card one iteration, over static tables, is captured into a CUDA graph
    at the first call (after an eager warm-up, ``mega._capture``) and
    replayed ``iters`` times. The graph holds the interaction tables it
    was captured with."""

    def __init__(self, sweep, device: torch.device):
        self._sweep = sweep
        self.device = device
        self._graph = None          # (graph, static U, static V, tables)
        self.capture = None         # warm-up / capture seconds, first call

    def _iteration(self, U, V, u_idx, u_rat, i_idx, i_rat, lam, alpha):
        U.copy_(self._sweep(V, u_idx, u_rat, lam, alpha))
        V.copy_(self._sweep(U, i_idx, i_rat, lam, alpha))

    def __call__(self, iters: int, U, V, *tables):
        if self.device.type != "cuda":
            U, V = U.clone(), V.clone()
            for _ in range(iters):
                self._iteration(U, V, *tables)
            return U, V
        if self._graph is None:
            from spfx_torch.kernels.mega import _capture
            sU, sV = U.clone(), V.clone()
            graph, _, warm, cap, _ = _capture(
                self.device, self._iteration, (sU, sV) + tuple(tables))
            self._graph = (graph, sU, sV, tables)
            self.capture = dict(warmup_s=warm, capture_s=cap)
        graph, sU, sV, held = self._graph
        if any(a is not b for a, b in zip(tables[:4], held[:4])) \
                or tables[4:] != held[4:]:
            raise ValueError("fit_steps: the graph was captured with other "
                             "interaction tables")
        sU.copy_(U)
        sV.copy_(V)
        for _ in range(iters):
            graph.replay()
        return sU.clone(), sV.clone()


def make_fit_steps(mesh: Mesh, implicit: bool, chunk: int) -> _FitSteps:
    """Multi-iteration training with no host wait: (iters, U, V, u_idx,
    u_rat, i_idx, i_rat, lam, alpha) -> (U, V); on the card one captured
    iteration replayed ``iters`` times."""
    return _FitSteps(make_sweep(mesh, implicit, chunk), mesh.devices[0])


@contextlib.contextmanager
def _score_precision():
    """JAX's default precision for ``topk``'s float32 score product: TF32
    on the card (the port's mapping of "default", ``mega._PRECISION``),
    full float32 on the CPU (torch's "medium" would take bf16 there, where
    JAX's CPU default is full float32)."""
    old = torch.get_float32_matmul_precision()
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)
        torch.backends.cuda.matmul.allow_tf32 = old_tf32


class ALSModel:
    """ALS/iALS model over a one-device mesh (the CUDA device unless
    ``device`` or ``mesh`` says otherwise)."""

    def __init__(self, data: Interactions, config: ALSConfig = ALSConfig(),
                 mesh: Mesh | None = None, device=None):
        from spfx_torch.kernels.mega import _PRECISION
        if config.matmul_precision not in _PRECISION:
            raise ValueError(f"unknown matmul precision "
                             f"{config.matmul_precision!r}")
        self.config = config
        self.data = data
        if mesh is None:
            mesh = make_mesh(devices=None if device is None else [device])
        self.mesh = mesh
        self.device = dev = mesh.devices[0]
        ndev = mesh.size
        c = config
        dtype = np.dtype(c.dtype)
        # pad table sizes so shards and per-device chunks divide evenly
        self.nu = round_up(data.num_users, c.chunk * ndev)
        self.ni = round_up(data.num_items, c.chunk * ndev)
        self.u_idx, self.u_rat = padded_rows(
            data.user_ids, data.item_ids, data.ratings, data.num_users,
            c.user_cap, pad_rows_to=self.nu)
        self.i_idx, self.i_rat = padded_rows(
            data.item_ids, data.user_ids, data.ratings, data.num_items,
            c.item_cap, pad_rows_to=self.ni)
        rng = np.random.default_rng(c.seed)
        scale = 1.0 / np.sqrt(c.rank)
        U0 = (rng.standard_normal((self.nu, c.rank)) * scale).astype(dtype)
        V0 = (rng.standard_normal((self.ni, c.rank)) * scale).astype(dtype)
        U0[data.num_users:] = 0      # alignment-padding rows must stay zero
        V0[data.num_items:] = 0      # (they feed the shared Gramian)
        self.U = torch.as_tensor(U0, device=dev)
        self.V = torch.as_tensor(V0, device=dev)
        self._sweep = make_sweep(mesh, c.implicit, c.chunk)
        self._fit_steps = None
        self._u_idx_d = torch.as_tensor(self.u_idx, device=dev)
        self._u_rat_d = torch.as_tensor(self.u_rat.astype(dtype), device=dev)
        self._i_idx_d = torch.as_tensor(self.i_idx, device=dev)
        self._i_rat_d = torch.as_tensor(self.i_rat.astype(dtype), device=dev)
        self._lam = float(c.lam)
        self._alpha = float(c.alpha)

    def _precision(self):
        from spfx_torch.kernels.mega import matmul_precision
        return matmul_precision(self.config.matmul_precision)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- training ---------------------------------------------------------

    def step(self):
        """One full ALS iteration (users then items), two sweeps."""
        with self._precision():
            self.U = self._sweep(self.V, self._u_idx_d, self._u_rat_d,
                                 self._lam, self._alpha)
            self.V = self._sweep(self.U, self._i_idx_d, self._i_rat_d,
                                 self._lam, self._alpha)

    def fit_steps(self, iters: int):
        """Run ``iters`` full iterations with no host wait (on the card, as
        replays of one captured iteration)."""
        if self._fit_steps is None:
            self._fit_steps = make_fit_steps(self.mesh, self.config.implicit,
                                             self.config.chunk)
        with self._precision():
            self.U, self.V = self._fit_steps(
                int(iters), self.U, self.V, self._u_idx_d, self._u_rat_d,
                self._i_idx_d, self._i_rat_d, self._lam, self._alpha)

    def fit(self, iters: int | None = None, log=None):
        iters = self.config.iters if iters is None else iters
        stats = []
        for it in range(iters):
            t0 = time.perf_counter()
            self.step()
            self._sync()
            dt = time.perf_counter() - t0
            ex_s = self.data.nnz * 2 / dt
            stats.append({"iter": it, "sec": dt, "examples_per_sec": ex_s})
            if log:
                log(f"iter {it}: {dt:.3f}s  {ex_s:,.0f} examples/s")
        return stats

    # -- evaluation -------------------------------------------------------

    def _tables(self):
        """(U, V) on the host as numpy, without their padding rows."""
        return (self.U[:self.data.num_users].detach().cpu().numpy(),
                self.V[:self.data.num_items].detach().cpu().numpy())

    def loss(self) -> float:
        """ALS objective on observed entries (monitoring only).

        For the implicit model this is the observed-entry part plus
        regularization (the full iALS objective also sums unobserved pairs;
        this cheaper surrogate is only used to monitor progress)."""
        U, V = self._tables()
        preds = np.einsum("nk,nk->n", U[self.data.user_ids],
                          V[self.data.item_ids])
        c = self.config
        if c.implicit:
            w = 1.0 + c.alpha * self.data.ratings
            err = float((w * (1.0 - preds) ** 2).sum())
        else:
            err = float(((self.data.ratings - preds) ** 2).sum())
        reg = c.lam * (float((U ** 2).sum()) + float((V ** 2).sum()))
        return err + reg

    def full_implicit_loss(self) -> float:
        """Exact iALS objective including all unobserved (u,i) pairs, via the
        Gramian identity: sum_ui (u.v)^2 = tr((U^T U)(V^T V)), in float64."""
        c = self.config
        U, V = (t.astype(np.float64) for t in self._tables())
        preds = np.einsum("nk,nk->n", U[self.data.user_ids],
                          V[self.data.item_ids])
        w = c.alpha * self.data.ratings
        # the JAX package's line closes float()'s parenthesis before .sum()
        # (spfx/recsys/als.py:254), which raises TypeError for more than
        # one interaction; the port sums first
        obs = float((w * (1.0 - preds) ** 2).sum()) \
            + float(((1.0 - preds) ** 2 - preds ** 2).sum())
        allpairs = float(np.trace((U.T @ U) @ (V.T @ V)))
        reg = c.lam * (float((U ** 2).sum()) + float((V ** 2).sum()))
        return obs + allpairs + reg

    def topk(self, k: int = 20, exclude_train: bool = True,
             chunk: int = 4096) -> np.ndarray:
        """Brute-force top-k retrieval: scores = U V^T (float32), the
        training items at -inf, ``torch.topk`` per user. Ties may come in
        another order than ``lax.top_k``'s."""
        nu = self.data.num_users
        ni = self.data.num_items
        out = np.zeros((nu, k), dtype=np.int32)
        V = self.V[:ni]
        with _score_precision():
            for c0 in range(0, nu, chunk):
                hi = min(c0 + chunk, nu)
                s = (self.U[c0:hi] @ V.t()).to(torch.float32)
                if exclude_train:
                    idx = torch.as_tensor(self.u_idx[c0:hi],
                                          device=self.device).long()
                    live = idx >= 0
                    rows = torch.arange(hi - c0, device=self.device)[:, None]
                    delta = torch.where(live, float("-inf"), 0.0).to(s.dtype)
                    s.index_put_((rows.expand_as(idx),
                                  torch.where(live, idx, 0)), delta,
                                 accumulate=True)
                got = torch.topk(s, k, dim=1).indices
                out[c0:hi] = got.cpu().numpy()
        return out

    def evaluate(self, test: Interactions, k_recall: int = 20,
                 k_ndcg: int = 10) -> dict:
        """recall@20 and NDCG@10 against a held-out set (vectorised)."""
        topk = self.topk(k=max(k_recall, k_ndcg))
        ni = int(self.data.num_items)
        test_keys = np.sort(test.user_ids.astype(np.int64) * ni
                            + test.item_ids)
        nrel = np.bincount(test.user_ids, minlength=test.num_users)
        users = np.flatnonzero(nrel > 0)
        keys = users[:, None].astype(np.int64) * ni + topk[users]
        hit = np.isin(keys, test_keys)
        recall = (hit[:, :k_recall].sum(axis=1)
                  / np.minimum(nrel[users], k_recall))
        discount = 1.0 / np.log2(np.arange(2, k_ndcg + 2))
        dcg = (hit[:, :k_ndcg] * discount[None, :]).sum(axis=1)
        cum = np.concatenate([[0.0], np.cumsum(discount)])
        idcg = cum[np.minimum(nrel[users], k_ndcg)]
        return {"recall@%d" % k_recall: float(recall.mean()),
                "ndcg@%d" % k_ndcg: float((dcg / idcg).mean()),
                "users_evaluated": int(len(users))}
