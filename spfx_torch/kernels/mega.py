"""One-launch factorization and device solve: ``MegaRunner`` and
``MegaSolver``.

Port of spfx/kernels/mega.py. The JAX runner compiles the whole step list
into one ``lax.scan`` with a ``lax.switch`` over shape classes, so one
factorization is one dispatch. Here the walk stays the plain Python loop
over the plan's levels (``walk_levels``): the assembly, then per level its
update buckets and its panel buckets, each dispatched by its kind as JAX's
per-call walk does (``update_step``: UT, UC or rowwin U; ``panel_step``: PC
or rowwin P). On a CUDA device the runner
captures that walk once per panel mode into a CUDA graph, and every later
factorization is one replay of it. The ``lax.switch`` machinery (packed
class tables, region-return branches) is not ported: a graph replays
launches whose shapes were fixed at capture.

Capture. The first ``run`` of a mode walks the plan once eagerly on a side
stream, which builds and loads every kernel library, uploads every bucket
table and creates the cuBLAS workspace, then captures the walk over static
entry-value buffers. The kernel wrappers count their launches on the host,
so the warm-up and the capture count and a replay does not: the capture's
counts are kept in ``captures[mode]["launches"]``, the replays in
``replays``. Precision is baked into the captured products; the config
fixes it per context (under "high" the float32 products are launches of
``matmul.bmm_bf16x3``, counted as ``bmm_bf16x3``). A failed build,
capture or replay raises: nothing falls back to the eager walk, which is
``engine="calls"``.

Each ``run`` copies the new entry values in, replays the graph and returns
a clone of the factor: the graph's output lives in its private memory pool
and the next replay overwrites it.

``MegaSolver`` runs the level solves over the levels' panel buckets
(``blocks.solve_fwd_level_c`` / ``solve_bwd_level_c`` on PC buckets,
``blocks.solve_fwd_level`` / ``solve_bwd_level`` on rowwin P buckets),
forward in order and backward in reverse; on a CUDA device one graph per
factor and right-hand-side count, cached by the factor, holds both
sweeps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time

import numpy as np
import torch

from spfx_torch.kernels import _cuda, blocks, matmul, route
from spfx_torch.plan.schedule import PanelBucketC, UpdateBucketC
from spfx_torch.utils import instrument
from spfx_torch.utils.config import Config, DEFAULT

# JAX matmul precision -> the float32 product setting of the walks.
# "default" and "bfloat16" (one bf16 pass on the TPU) become TF32 on the
# card, which is finer, and full float32 on the CPU, as JAX's CPU backend
# runs them. torch's process-wide float32 setting would not do: its
# "medium" is TF32 for cuBLAS but bf16 for oneDNN on the CPU. So torch's
# setting stays "highest" (full float32 on both backends) and only cuBLAS
# gets TF32 (torch.backends.cuda.matmul.allow_tf32). "high" (bf16x3) keeps
# torch at full float32 for whatever product does not go through
# matmul.bmm, and matmul.bmm runs the walks' float32 products as the bf16x3
# kernel (matmul.bmm_bf16x3).
_PRECISION = {"highest": "highest", "float32": "highest",
              "default": "tf32", "bfloat16": "tf32", "high": "highest"}


def _mode(name: str) -> str:
    """The product mode a JAX precision name selects: "high", "tf32" (TF32
    on the card, full float32 on the CPU) or "highest"."""
    return "high" if name == "high" else _PRECISION[name]


@contextlib.contextmanager
def matmul_precision(name: str):
    """float32 matrix products at the JAX precision ``name`` ("highest":
    full float32, no TF32; "default": TF32 on the card, full float32 on the
    CPU; "high": matmul.bmm's bf16x3 kernel), restored afterwards."""
    old = torch.get_float32_matmul_precision()
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = _PRECISION[name] == "tf32"
    try:
        with matmul.precision(_mode(name)):
            yield
    finally:
        torch.set_float32_matmul_precision(old)
        torch.backends.cuda.matmul.allow_tf32 = old_tf32


def update_precision(config: Config):
    """The context for the update steps inside the walk's
    ``matmul_precision(config.matmul_precision)``: a no-op unless
    ``config.update_precision`` selects another product mode."""
    upd = config.update_precision or config.matmul_precision
    if _mode(upd) == _mode(config.matmul_precision):
        return contextlib.nullcontext
    return functools.partial(matmul_precision, upd)


@dataclasses.dataclass
class _Graph:
    """A captured walk: the graph, its static inputs and its outputs (and
    the step stamps captured in it, if any)."""
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple
    outputs: tuple
    stamps: "instrument.Stamps | None" = None


def _capture(device, fn, inputs, pool=None) -> tuple:
    """Warm ``fn(*inputs)`` up once eagerly on a side stream, then capture
    it into a CUDA graph (in the memory pool ``pool``, a private one when
    None). Returns (graph, outputs, warm-up s, capture s, launch counts of
    the capture)."""
    with torch.cuda.device(device):
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*inputs)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = _cuda.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # thread_local: a host thread that plans the next matrix (the CLI's
        # prefetch) may call the CUDA runtime meanwhile
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            out = fn(*inputs)
        after = _cuda.launch_counts()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return (graph, out, t1 - t0, t2 - t1,
            {k: after[k] - before[k] for k in after})


def update_step(arrays, ub, device, lu: bool, out=None,
                tasks: tuple | None = None) -> None:
    """One update bucket, by its kind: UT (``UpdateBucketC`` with head
    windows), UC (without) or rowwin U (``UpdateBucket``). Reads
    ``arrays`` ((L,) or (Lx, Ux)) and subtracts the update rows from
    ``out`` (the same arrays, in place, when None). ``tasks`` (lo, hi)
    runs only those tasks of the bucket (the sharded walk's slice; a UT
    or UC bucket's tasks share one slab, so the slab stays)."""
    out = tuple(arrays if out is None else out)
    out = out if lu else out[0]
    lo, hi = (0, len(ub.kw)) if tasks is None else tasks
    if not isinstance(ub, UpdateBucketC):
        fn = blocks.apply_updates_lu if lu else blocks.apply_updates_sym
        fn(*arrays, *(t[lo:hi] for t in ub.to(device)), kp=ub.kp,
           csp=ub.csp, out=out)
        return
    slab_lo = int(ub.slab_lo[0])
    *head, _, rows, tgt_cpos = ub.to(device)
    head = [t[lo:hi] for t in head]
    # the flat row table holds each task's rows in turn
    rows = rows.view(len(ub.kw), -1)[lo:hi].reshape(-1)
    tgt_cpos = tgt_cpos[lo:hi]
    if ub.head_start is not None:
        fn = blocks.apply_updates_lu_t if lu else blocks.apply_updates_sym_t
        fn(*arrays, *head, slab_lo, rows, tgt_cpos, mp=ub.mp, kp=ub.kp,
           csp=ub.csp, srows=ub.slab_rows, out=out)
        return
    fn = blocks.apply_updates_lu_c if lu else blocks.apply_updates_sym_c
    fn(*arrays, *head, slab_lo, rows, tgt_cpos, mp=ub.mp, kp=ub.kp,
       csp=ub.csp, srows=ub.slab_rows, out=out)


def panel_step(arrays, pb, device, lu: bool, mode: str, out=None,
               tasks: tuple | None = None) -> None:
    """One panel bucket, by its kind: PC (``PanelBucketC``, one uniform
    block) or rowwin P (``PanelBucket``), under panel mode ``mode``. Reads
    ``arrays`` and adds the panels' deltas into ``out`` (``arrays``, in
    place, when None); ``tasks`` (lo, hi) as in ``update_step``."""
    out = tuple(arrays if out is None else out)
    out = out if lu else out[0]
    lo, hi = (0, len(pb.widths)) if tasks is None else tasks
    if isinstance(pb, PanelBucketC):
        widths, nbelow, _ = pb.to_u(device)
        fn = blocks.factor_panels_lu_u if lu else blocks.factor_panels_chol_u
        fn(*arrays, widths[lo:hi], nbelow[lo:hi],
           int(pb.slab_lo[0]) + lo * (pb.cp + pb.rbp) * pb.cp, cp=pb.cp,
           rbp=pb.rbp, mode=mode, out=out)
        return
    fn = blocks.factor_panels_lu if lu else blocks.factor_panels_chol
    fn(*arrays, *(t[lo:hi] for t in pb.to_f(device)), mode=mode,
       out=out)


def walk_levels(arrays, levels, lu: bool, config: Config, device,
                mode: str, stamp=None) -> None:
    """The left-looking level walk over ``levels``, in place: per level
    its pending updates (at the config's update precision), then its
    panels. ``stamp`` (an ``instrument.Stamps``), when given, is called
    after each level's updates and after its panels."""
    upd_ctx = update_precision(config)
    with matmul_precision(config.matmul_precision):
        for lp in levels:
            with upd_ctx():
                for ub in lp.updates:
                    update_step(arrays, ub, device, lu)
            if stamp is not None:
                stamp()
            for pb in lp.panels:
                panel_step(arrays, pb, device, lu, mode)
            if stamp is not None:
                stamp()


def solve_step(F, x, pb, device, lu: bool, forward: bool) -> None:
    """One panel bucket's level solve, in place on x, by the bucket's
    kind."""
    if isinstance(pb, PanelBucketC):
        fn = blocks.solve_fwd_level_c if forward else blocks.solve_bwd_level_c
        fn(F, x, *pb.to(device), cp=pb.cp, rbp=pb.rbp, lu=lu)
    else:
        fn = blocks.solve_fwd_level if forward else blocks.solve_bwd_level
        fn(F, x, *pb.to(device), lu=lu)


def _device(device) -> torch.device:
    """``device``, else the CUDA device (raises without one)."""
    from spfx_torch.chol.factorize import resolve_device
    return resolve_device(device)


class MegaRunner:
    """One factorization per launch for a FactorPlan (Cholesky or LU) on
    ``device`` (the CUDA device unless given): a CUDA-graph replay on the
    card, the eager walk on the CPU."""

    def __init__(self, plan, lu: bool = False, config: Config = DEFAULT,
                 device=None):
        self.plan = plan
        self.lu = lu
        self.config = config
        self.device = _device(device)
        idx = (plan.assembly_idx, plan.assembly_idx_u) if lu \
            else (plan.assembly_idx,)
        self._asm = tuple(torch.as_tensor(i.astype(np.int64),
                                          device=self.device) for i in idx)
        self._graphs: dict = {}     # panel mode -> _Graph
        # panel mode -> {"warmup_s", "capture_s", "first_replay_s",
        # "launches"}: the first run of each mode
        self.captures: dict = {}
        self.replays = 0

    def _once(self, vals, vals_u=None, mode: str | None = None,
              stamps=None):
        """One eager factorization from permuted lower(-and-upper^T) entry
        values: the assembly into fresh storage, then the level walk, in
        place. ``mode`` is the panel-kernel mode (``route.panel_mode()``
        when None); ``stamps`` (an ``instrument.Stamps``) marks the start,
        the end of the assembly and each level's steps."""
        mode = route.panel_mode() if mode is None else mode
        if stamps is not None:
            stamps()
        arrays = [blocks.assemble(a, v, self.plan.storage)
                  for a, v in zip(self._asm, (vals, vals_u))]
        if stamps is not None:
            stamps()
        walk_levels(arrays, self.plan.levels, self.lu, self.config,
                    self.device, mode, stamp=stamps)
        return tuple(arrays) if self.lu else arrays[0]

    def trace_fn(self):
        """The eager whole-factorization callable (vals[, vals_u]) ->
        factor, under the panel mode set when it is called: what
        ``engine="calls"`` runs."""
        if not self.lu:
            return lambda vals: self._once(vals)
        return lambda vl, vu: self._once(vl, vu)

    def run(self, vals, vals_u=None):
        """Factorize from permuted lower(-and-upper^T) entry values: one
        graph replay on the card, the eager walk on the CPU."""
        return self.run_repeat(1, vals, vals_u)

    def run_repeat(self, reps: int, vals, vals_u=None):
        """``reps`` back-to-back factorizations, the last one's factor
        returned: on the card ``reps`` replays on one stream, which are
        ordered without a data dependence (the bench's slope path)."""
        if reps < 1:
            raise ValueError(f"run_repeat: reps must be >= 1, got {reps}")
        mode = route.panel_mode()      # SPFX_PANEL_KERNEL, once a call
        if self.device.type != "cuda":
            with instrument.span("spfx.replay", reps=reps):
                for _ in range(reps):
                    stamps = instrument.stamps(
                        len(self.plan.levels), self.device)
                    out = self._once(vals, vals_u, mode, stamps)
                    instrument.note_steps(mode, stamps)
            return out
        inputs = (vals, vals_u) if self.lu else (vals,)
        g = self._graphs.get(mode)
        fresh = g is None
        if fresh:
            g = self._graphs[mode] = self._capture(mode, inputs)
        with instrument.timed("spfx.replay", reps=reps) as sp:
            for dst, src in zip(g.inputs, inputs):
                if src.shape != dst.shape or src.dtype != dst.dtype \
                        or src.device != dst.device:
                    raise ValueError(
                        f"MegaRunner: entry values {tuple(src.shape)} "
                        f"{src.dtype} on {src.device}, the graph takes "
                        f"{tuple(dst.shape)} {dst.dtype} on {dst.device}")
                dst.copy_(src)
            for _ in range(reps):
                g.graph.replay()
                self.replays += 1
                instrument.count("replays")
            out = tuple(t.clone() for t in g.outputs)
        instrument.note_steps(mode, g.stamps)
        if fresh:
            torch.cuda.synchronize(self.device)
            self.captures[mode]["first_replay_s"] = (time.perf_counter()
                                                     - sp.start_s)
        return out if self.lu else out[0]

    def _capture(self, mode: str, inputs) -> _Graph:
        """Capture the walk of ``mode`` over static copies of ``inputs``,
        with step stamps when the recorder is on."""
        with instrument.span("spfx.capture", mode=mode) as sp:
            static = tuple(v.clone() for v in inputs)
            stamps = instrument.stamps(len(self.plan.levels), self.device)
            graph, out, warm, cap, launches = _capture(
                self.device, functools.partial(self._once, mode=mode,
                                               stamps=stamps), static)
            sp.set(warmup_s=warm, capture_s=cap, launches=launches)
        self.captures[mode] = dict(warmup_s=warm, capture_s=cap,
                                   launches=launches)
        return _Graph(graph, static, out if self.lu else (out,), stamps)


class MegaSolver:
    """Forward and backward level-batched triangular solves over the panel
    buckets of a plan (PC or rowwin P), on ``device`` (the CUDA device
    unless given). The bucket tables are uploaded at the first solve."""

    def __init__(self, plan, lu: bool = False, config: Config = DEFAULT,
                 device=None):
        self.plan = plan
        self.lu = lu
        self.config = config
        self.device = _device(device)
        # nrhs -> {"warmup_s", "capture_s", "launches"}: the latest capture
        # of a solve graph for that many right-hand sides
        self.captures: dict = {}

    def _panels(self):
        return [pb for lp in self.plan.levels for pb in lp.panels]

    def forward(self, F, x):
        """x <- L^{-1} x over the levels in order, in place (L unit for
        LU)."""
        for pb in self._panels():
            solve_step(F, x, pb, self.device, self.lu, forward=True)
        return x

    def backward(self, F, x):
        """x <- L^{-T} x (LU: U^{-1} x, with F = U^T) over the levels in
        reverse, in place."""
        for pb in reversed(self._panels()):
            solve_step(F, x, pb, self.device, self.lu, forward=False)
        return x

    def _eager(self, F, G, x):
        with matmul_precision(self.config.matmul_precision):
            return self.backward(G, self.forward(F, x))

    def solve(self, F, G, x, graphs: dict):
        """Forward over F, then backward over G, of x (n + 1, nrhs) (row n
        the sentinel), in place on the CPU. On the card the two sweeps are
        one replay of a graph that ``graphs`` (a dict the factor owns)
        keeps by nrhs; the solution is returned as a new tensor."""
        if self.device.type != "cuda":
            return self._eager(F, G, x)
        nrhs = x.shape[1]
        g = graphs.get(nrhs)
        if g is None:
            with instrument.span("spfx.solve.capture", nrhs=nrhs) as sp:
                static = torch.zeros_like(x)
                graph, out, warm, cap, launches = _capture(
                    self.device, functools.partial(self._eager, F, G),
                    (static,))
                sp.set(warmup_s=warm, capture_s=cap)
            self.captures[nrhs] = dict(warmup_s=warm, capture_s=cap,
                                       launches=launches)
            g = graphs[nrhs] = _Graph(graph, (static,), (out,))
        with instrument.span("spfx.solve.graph", nrhs=nrhs) as sp:
            g.inputs[0].copy_(x)
            pair = sp.device_pair()
            if pair is not None:
                pair[0].record()
            g.graph.replay()
            if pair is not None:
                pair[1].record()
            # the caller's .cpu() would wait here anyway
            torch.cuda.synchronize(self.device)
            return g.outputs[0].clone()
