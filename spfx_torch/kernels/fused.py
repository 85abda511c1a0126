"""Chunked execution of rowwin plans: ``engine="fused"``.

Port of spfx/kernels/fused.py. The JAX engine groups consecutive schedule
levels into chunks of at most ``Config.calls_per_chunk`` bucket calls
(``chunk_levels``) and traces each chunk into one jit program, so a
factorization is one dispatch per chunk. Here each chunk is the same level
walk as ``mega.walk_levels``; on a CUDA device each chunk is captured once
per panel mode into a CUDA graph (``mega._capture``, all of a runner's
graphs in one memory pool) and a factorization replays the chunks' graphs
in order over the runner's own factor storage. The first chunk's graph
also assembles the entry values into that storage. On the CPU each chunk
runs eagerly.

Like JAX's, both classes take rowwin plans only and raise ``ValueError``
on a contig plan (one with PC buckets).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from spfx_torch.kernels import route
from spfx_torch.kernels.mega import (_capture, _device, matmul_precision,
                                     solve_step, walk_levels)
from spfx_torch.plan.schedule import PanelBucketC
from spfx_torch.utils.config import Config, DEFAULT

CALLS_PER_CHUNK = 24


def chunk_levels(levels, calls_per_chunk: int = CALLS_PER_CHUNK):
    """Greedily group consecutive levels into chunks of bounded call
    count."""
    chunks = []
    cur, calls = [], 0
    for lp in levels:
        c = len(lp.panels) + len(lp.updates)
        if cur and calls + c > calls_per_chunk:
            chunks.append(cur)
            cur, calls = [], 0
        cur.append(lp)
        calls += c
    if cur:
        chunks.append(cur)
    return chunks


def _require_rowwin(plan) -> None:
    if any(isinstance(pb, PanelBucketC)
           for lp in plan.levels for pb in lp.panels):
        raise ValueError(
            "engine='fused' supports only Config(layout='rowwin') plans")


class _ChunkGraphs:
    """CUDA graphs of in-place steps over static tensors, captured in
    order into one memory pool and replayed in that order."""

    def __init__(self, device, steps, static):
        self.static = static
        self.graphs = []
        self.warmup_s = self.capture_s = 0.0
        self.launches: dict = {}
        pool = torch.cuda.graph_pool_handle()
        for step in steps:
            g, _, warm, cap, counts = _capture(device, step, static, pool)
            self.graphs.append(g)
            self.warmup_s += warm
            self.capture_s += cap
            for k, v in counts.items():
                self.launches[k] = self.launches.get(k, 0) + v

    def replay(self) -> None:
        for g in self.graphs:
            g.replay()


class FusedRunner:
    """Chunked factorizations of a rowwin FactorPlan (Cholesky or LU) on
    ``device`` (the CUDA device unless given): per chunk one CUDA-graph
    replay on the card, the eager walk on the CPU."""

    def __init__(self, plan, lu: bool = False, config: Config = DEFAULT,
                 device=None):
        _require_rowwin(plan)
        self.plan = plan
        self.lu = lu
        self.config = config
        self.device = _device(device)
        self.chunks = chunk_levels(plan.levels, config.calls_per_chunk)
        idx = (plan.assembly_idx, plan.assembly_idx_u) if lu \
            else (plan.assembly_idx,)
        self._asm = tuple(torch.as_tensor(i.astype(np.int64),
                                          device=self.device) for i in idx)
        self._graphs: dict = {}     # panel mode -> _ChunkGraphs
        # panel mode -> {"warmup_s", "capture_s", "first_replay_s",
        # "launches", "chunks"}: the first run of each mode
        self.captures: dict = {}
        self.replays = 0

    def _assemble(self, arrays, vals) -> None:
        """The entry values scattered into the factor storage ``arrays``,
        in place."""
        for F, a, v in zip(arrays, self._asm, vals):
            F.zero_()
            F[a] = v

    def _step(self, i: int, mode: str, *static) -> None:
        """Chunk ``i`` over static = (vals[, vals_u], L[, Ux]), in place;
        chunk 0 assembles first."""
        k = len(static) // 2
        if i == 0:
            self._assemble(static[k:], static[:k])
        walk_levels(static[k:], self.chunks[i], self.lu, self.config,
                    self.device, mode)

    def _eager(self, vals, mode: str):
        """The chunks run eagerly in order over fresh storage."""
        arrays = [torch.empty(self.plan.storage, dtype=v.dtype,
                              device=v.device) for v in vals]
        for i in range(len(self.chunks)):
            self._step(i, mode, *vals, *arrays)
        return tuple(arrays) if self.lu else arrays[0]

    def trace_fn(self):
        """The eager whole-factorization callable (vals[, vals_u]) ->
        factor, under the panel mode set when it is called."""
        return lambda *vals: self._eager(vals, route.panel_mode())

    def run(self, vals, vals_u=None):
        """Factorize from permuted lower(-and-upper^T) entry values: the
        chunks' graphs replayed in order on the card, the chunks run
        eagerly on the CPU."""
        mode = route.panel_mode()
        vals = (vals, vals_u) if self.lu else (vals,)
        if self.device.type != "cuda":
            return self._eager(vals, mode)
        g = self._graphs.get(mode)
        fresh = g is None
        if fresh:
            static = tuple(v.clone() for v in vals) + tuple(
                torch.empty(self.plan.storage, dtype=v.dtype,
                            device=self.device) for v in vals)
            steps = [functools.partial(self._step, i, mode)
                     for i in range(len(self.chunks))]
            g = self._graphs[mode] = _ChunkGraphs(self.device, steps, static)
            self.captures[mode] = dict(warmup_s=g.warmup_s,
                                       capture_s=g.capture_s,
                                       launches=g.launches,
                                       chunks=len(g.graphs))
        t0 = time.perf_counter()
        k = len(vals)
        for dst, src in zip(g.static[:k], vals):
            if src.shape != dst.shape or src.dtype != dst.dtype \
                    or src.device != dst.device:
                raise ValueError(
                    f"FusedRunner: entry values {tuple(src.shape)} "
                    f"{src.dtype} on {src.device}, the graphs take "
                    f"{tuple(dst.shape)} {dst.dtype} on {dst.device}")
            dst.copy_(src)
        g.replay()
        self.replays += 1
        out = tuple(t.clone() for t in g.static[k:])
        if fresh:
            torch.cuda.synchronize(self.device)
            self.captures[mode]["first_replay_s"] = time.perf_counter() - t0
        return out if self.lu else out[0]


class FusedSolver:
    """Chunked forward and backward level solves of a rowwin plan: the
    forward sweep in chunks of the levels in order, the backward sweep in
    chunks of the levels reversed; on the card one graph per chunk, kept
    by the factor per right-hand-side count."""

    def __init__(self, plan, lu: bool = False, config: Config = DEFAULT,
                 device=None):
        _require_rowwin(plan)
        self.lu = lu
        self.config = config
        self.device = _device(device)
        cpc = config.calls_per_chunk
        self.fwd_chunks = chunk_levels(plan.levels, cpc)
        self.bwd_chunks = chunk_levels(list(reversed(plan.levels)), cpc)

    def _sweep(self, F, x, levels, forward: bool) -> None:
        with matmul_precision(self.config.matmul_precision):
            for lp in levels:
                for pb in lp.panels:
                    solve_step(F, x, pb, self.device, self.lu, forward)

    def _steps(self, F, G):
        return ([functools.partial(self._sweep, F, levels=c, forward=True)
                 for c in self.fwd_chunks]
                + [functools.partial(self._sweep, G, levels=c, forward=False)
                   for c in self.bwd_chunks])

    def forward(self, F, x):
        """x <- L^{-1} x, chunk by chunk, in place."""
        for c in self.fwd_chunks:
            self._sweep(F, x, c, True)
        return x

    def backward(self, F, x):
        """x <- L^{-T} x (LU: U^{-1} x, F = U^T), chunk by chunk, in
        place."""
        for c in self.bwd_chunks:
            self._sweep(F, x, c, False)
        return x

    def solve(self, F, G, x, graphs: dict):
        """Forward over F, then backward over G, of x (n + 1, nrhs), in
        place on the CPU; on the card the chunks' graphs, kept in
        ``graphs`` by nrhs, replayed in order, and the solution returned
        as a new tensor."""
        if self.device.type != "cuda":
            return self.backward(G, self.forward(F, x))
        nrhs = x.shape[1]
        g = graphs.get(nrhs)
        if g is None:
            g = graphs[nrhs] = _ChunkGraphs(
                self.device, self._steps(F, G), (torch.zeros_like(x),))
        g.static[0].copy_(x)
        g.replay()
        return g.static[0].clone()
