"""Subtree-decomposed factorization over a process group: ranks own
disjoint elimination subtrees, and the shared top runs batch-sharded.

Port of spfx/dist/subtree.py. The plan assigns each rank a set of
elimination subtrees (``assign_owners``: an ancestor of any supernode lies
in the same subtree or above every subtree), so:

- LOCAL PHASE (no communication): each rank walks its own plan (the full
  analysis planned with ``sn_filter = owner == rank``): every panel of its
  supernodes and every update sourced at them, those into shared
  ancestors included. It is the in-core walk over that plan
  (``mega.MegaRunner``): on the card one CUDA-graph replay after the first
  factorization's capture, the eager walk on the CPU.
- MERGE: every rank starts from the same assembled A and writes only its
  subtrees and their ancestors' rows, so the merged factor is
  L0 + all_reduce(L - L0): one factor-sized all-reduce (LU: two).
- TOP PHASE: the shared top region's levels, batch-sharded
  (``spfx_torch.dist.factorize.sharded_walk`` over the top plan): two
  all-reduces a level there, where the batch-sharded engine pays them at
  every level.

Every plan is built over the same analysis with the same storage key
(``sn_group = owner + 1``), so the layout is the same on every rank and
in the full plan, which backs assembly, solve and validation; all plans
take one trailing slack, the largest, before any bucket is uploaded. The
JAX package's union of per-chip class tables (``_union_tables``) and its
``lax.switch``/``scan`` program are its SPMD machinery and have no
counterpart here: each rank walks only its own plan.
"""

from __future__ import annotations

import heapq
import time

import numpy as np
import scipy.sparse as sp
import torch

from spfx_torch.chol.factorize import (CholeskyFactor, _DTYPES, check_config,
                                       check_windows, entry_values)
from spfx_torch.dist.factorize import (check_same_plan, mesh_of,
                                       plan_digest, sharded_walk)
from spfx_torch.dist.mesh import Mesh, all_gather_object, all_reduce_
from spfx_torch.kernels import blocks, route
from spfx_torch.kernels.mega import MegaRunner, MegaSolver
from spfx_torch.lu.factorize import LUFactor
from spfx_torch.plan.schedule import build_plan
from spfx_torch.symbolic.analyze import analyze
from spfx_torch.utils.config import Config, DEFAULT


def sn_parent(sym) -> np.ndarray:
    """Supernodal elimination tree: parent supernode of each supernode
    (-1 at roots) — the column etree restricted to supernode last columns
    (ref ST_Parent, Cholesky/Source/SparseFrame.c:1640-1665)."""
    last = sym.sn_start[1:] - 1
    p = sym.parent[last]
    return np.where(p >= 0, sym.sn_of[np.maximum(p, 0)], -1)


def _sn_flops(sym) -> np.ndarray:
    """Per-supernode numeric work estimate for load balancing: panel
    factorization plus (approximately) the update products it sources."""
    W = np.diff(sym.sn_start).astype(np.float64)
    nb = (np.diff(sym.sn_ptr) - np.diff(sym.sn_start)).astype(np.float64)
    return W**3 / 3.0 + nb * W**2 + 2.0 * nb * nb * W


def assign_owners(sym, ndev: int, factor: int = 4) -> np.ndarray:
    """owner[s] in [0, ndev) for supernodes of chip-owned subtrees, -1 for
    the shared top region. Splits the largest subtrees until ~factor*ndev
    candidates exist, then LPT-packs them into ndev balanced bins.

    The etree is postordered (analyze guarantees it), so a subtree is a
    contiguous supernode id range [first_descendant(s), s]."""
    ns = sym.nsuper
    par = sn_parent(sym)
    own = _sn_flops(sym)
    sub = own.copy()
    fd = np.arange(ns)
    for s in range(ns):
        p = par[s]
        if p >= 0:
            sub[p] += sub[s]
            fd[p] = min(fd[p], fd[s])
    children = [[] for _ in range(ns)]
    for s in range(ns):
        if par[s] >= 0:
            children[par[s]].append(s)
    total = float(sub[par < 0].sum())
    # max-heap of candidate subtree roots. Split any candidate bigger than
    # half a bin (it would break LPT balance); splitting a node moves only
    # that node's own work into the shared top region, so this rule keeps
    # the top as small as balance allows.
    cands = [(-sub[s], int(s)) for s in np.flatnonzero(par < 0)]
    heapq.heapify(cands)
    big = total / max(1, 2 * ndev)           # breaks LPT balance if kept
    small = total / max(1, 4 * factor * ndev)  # not worth the top growth
    done = []
    while cands:
        negf, s = heapq.heappop(cands)
        want = len(done) + len(cands) < factor * ndev or -negf > big
        if not children[s] or not want or -negf < small:
            done.append((negf, s))
            continue
        for c in children[s]:        # s itself joins the top region
            heapq.heappush(cands, (-sub[c], int(c)))
    cands = done
    owner = np.full(ns, -1, dtype=np.int64)
    bins = [(0.0, b) for b in range(ndev)]
    heapq.heapify(bins)
    for negf, s in sorted(cands):
        load, b = heapq.heappop(bins)
        owner[fd[s]:s + 1] = b
        heapq.heappush(bins, (load - negf, b))
    return owner


class _SubtreeBase:
    """Shared machinery for the subtree-decomposed engines."""

    lu = False

    def __init__(self, A: sp.spmatrix, config: Config = DEFAULT,
                 mesh: Mesh | None = None, axis: str | None = None,
                 sym=None, device=None):
        check_config(config)
        A = sp.csc_matrix(A)
        if config.layout != "contig":
            raise ValueError("subtree engine requires layout='contig'")
        self.A = A
        self.config = config
        self.mesh = mesh_of(mesh, axis, device)
        self.axis = axis or self.mesh.axis_names[0]
        self.ndev = self.mesh.size
        self.device = self.mesh.device
        self.dtype = _DTYPES[config.dtype]
        t0 = time.perf_counter()
        self.sym = sym if sym is not None else analyze(
            A, config, symmetrize=self.lu)
        self.analyze_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.owner = assign_owners(self.sym, self.ndev)
        grp = self.owner + 1            # top region sorts first within class
        # this rank's plan, the top plan and the full plan (same layout),
        # which backs assembly, solve and validation
        self.local_plan = build_plan(
            self.sym, A, config, lu=self.lu,
            sn_filter=(self.owner == self.mesh.rank), sn_group=grp)
        self.top_plan = build_plan(self.sym, A, config, lu=self.lu,
                                   sn_filter=(self.owner == -1), sn_group=grp)
        self.plan = build_plan(self.sym, A, config, lu=self.lu, sn_group=grp)
        # one shared storage size: filtered plans grow slack independently
        got = all_gather_object(self.mesh, (self.local_plan.slack,
                                            self.local_plan.flops))
        smax = max([s for s, _ in got]
                   + [self.top_plan.slack, self.plan.slack])
        for p in (self.local_plan, self.top_plan, self.plan):
            p.slack = smax
            check_windows(p)
        self.plan_time = time.perf_counter() - t0
        self.local_flops = [f for _, f in got]
        self.top_flops = self.top_plan.flops
        self.top_levels = sum(1 for lp in self.top_plan.levels
                              if lp.updates or lp.panels)
        check_same_plan(self.mesh, plan_digest(self.sym, self.plan,
                                               self.owner))
        for p in (self.local_plan, self.top_plan):
            if plan_digest(self.sym, p) != plan_digest(self.sym, self.plan):
                raise RuntimeError("subtree: a filtered plan's storage "
                                   "layout is not the full plan's")
        self._runner = MegaRunner(self.local_plan, lu=self.lu, config=config,
                                  device=self.device)
        self._solver = MegaSolver(self.plan, lu=self.lu, config=config,
                                  device=self.device)
        self._asm = None

    def _factor(self, A):
        """The factor arrays of A: the local phase (this rank's plan, a
        graph replay on the card), the merge, then the top phase."""
        from spfx_torch.utils.instrument import profile_scope
        if self._asm is None:
            idx = (self.plan.assembly_idx, self.plan.assembly_idx_u) \
                if self.lu else (self.plan.assembly_idx,)
            self._asm = tuple(torch.as_tensor(i.astype(np.int64),
                                              device=self.device)
                              for i in idx)
        vals = entry_values(self.sym, A, self.config.dtype, self.device,
                            self.lu)
        with profile_scope(self.config, "factorize"):
            local = self._runner.run(*vals)
            local = local if self.lu else (local,)
            arrays = []
            for a, v, loc in zip(self._asm, vals, local):
                L0 = blocks.assemble(a, v, self.plan.storage)
                d = all_reduce_(self.mesh, loc - L0)
                arrays.append(L0.add_(d))
            sharded_walk(arrays, self.top_plan.levels, self.lu, self.config,
                         self.mesh, route.panel_mode())
        return arrays


class SubtreeCholesky(_SubtreeBase):
    """Cholesky context with subtree-owned factorization over a mesh of
    ranks. Usage mirrors ``ShardedCholesky``; the communication per
    factorization is one factor-sized all-reduce plus two a top level,
    where ``ShardedCholesky`` makes two at every level."""

    lu = False

    def factorize(self, A: sp.spmatrix) -> CholeskyFactor:
        from spfx_torch.utils.instrument import finish_factorize
        A = sp.csc_matrix(A)
        t0 = time.perf_counter()
        (L,) = self._factor(A)
        f = CholeskyFactor(A, self.sym, self.plan, L, self.config,
                           solver=self._solver)
        return finish_factorize(self, f, t0)


class SubtreeLU(_SubtreeBase):
    """LU (no-pivot) context with subtree-owned factorization."""

    lu = True

    def factorize(self, A: sp.spmatrix) -> LUFactor:
        from spfx_torch.utils.instrument import finish_factorize
        A = sp.csc_matrix(A)
        t0 = time.perf_counter()
        Lx, Ux = self._factor(A)
        f = LUFactor(A, self.sym, self.plan, Lx, Ux, self.config,
                     solver=self._solver)
        return finish_factorize(self, f, t0)
