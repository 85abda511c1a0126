"""Stage-streamed factorization: factors larger than device memory (and
larger than the 2^31-element int32 addressing ceiling of the in-core
engines).

Port of spfx/stream/engine.py. The host logic is the JAX package's, copied:

- the level-major uniform storage layout (``spfx_torch.plan.schedule``)
  makes every stage's OWN region one contiguous range [stage_lo, stage_hi);
- a stage's update tasks read only FINISHED descendant panels, all known
  at plan time, so the engine host-gathers exactly those panels into a
  packed stage buffer, each at a position congruent to its global start
  mod ALIGN (the update tables' superwindow offsets were built from
  global starts), then places the own region after them;
- the global plan is built with int64 tables (``build_plan(idx_dtype=
  np.int64)``) and every stage's buckets are REBASED to stage-local int32
  offsets, which is what lifts the global 2^31 ceiling.

A rebased bucket gets fresh, empty device caches: the bucket classes cache
their uploaded tables in ``_dev`` dicts, and ``dataclasses.replace`` would
hand the rebased bucket its original's dict, with the un-rebased offsets
in it once the original was uploaded.

Per stage the buffer arrives assembled, so the stage runs no assembly:
``kernels.mega.walk_levels`` walks the stage's rebased levels over it, in
place (the JAX package's per-stage ``lax.scan`` / ``lax.switch`` over
flattened class tables is TPU machinery and is not carried over). On the
card the buffer goes up from a pinned host buffer and the own region comes
back the same way, both asynchronous copies (the slack past the own
region is zeroed on the device, not sent), with one synchronize before
the own region is read back. One device buffer (and its twin for LU),
sized to the largest stage, serves every stage; each stage's walk is
captured into a CUDA graph over that buffer at the first factorization of
a panel mode, all stages in one shared memory pool (they replay in
capture order), so the device holds one stage's working set, never the
whole factor. On the CPU the walk runs eagerly on each stage buffer.

The host array is the factor of record (``_Lh``; LU ``_host``). The host
solve reads it directly; the device solve (``solve_backend="device"``, or
a complex factor) uploads it once at its first solve and keeps it, with
its solve graphs, on the factor.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import scipy.sparse as sp
import torch

from spfx_torch.chol.factorize import (_DTYPES, CholeskyFactor, check_config,
                                       check_windows, device_solve,
                                       resolve_device)
from spfx_torch.kernels import route
from spfx_torch.kernels.mega import _capture, walk_levels
from spfx_torch.lu.factorize import LUFactor
from spfx_torch.plan.schedule import (ALIGN, FactorPlan, LevelPlan,
                                      PanelBucketC, UpdateBucketC,
                                      build_plan)
from spfx_torch.symbolic.analyze import analyze
from spfx_torch.utils.config import Config, DEFAULT


@dataclasses.dataclass
class _Stage:
    levels: List[LevelPlan]        # rebased per-stage buckets
    lo: int                        # own region start (global, int64)
    hi: int                        # own region end (global)
    src_sns: np.ndarray            # descendant supernodes packed as input
    src_lo: np.ndarray             # (nsrc,) global start of each source
    src_len: np.ndarray            # (nsrc,) elements of each source
    src_base: np.ndarray           # (nsrc,) stage-buffer position of each
    #                                source, CONGRUENT to src_lo mod the
    #                                ALIGN tile (the update tables'
    #                                superwindow row offsets were built
    #                                from global starts)
    packed: int                    # total packed source elements
    storage: int                   # packed + own + slack (stage buffer)
    runs: np.ndarray = None        # (R, 3) copies that pack the buffer:
    #                                (buffer start, host start, length),
    #                                sources adjacent in both merged


def _stage_partition(plan: FactorPlan, offsets, rows_elems, cap: int):
    """Greedy level partition: a stage's device working set (its own
    contiguous region + its packed source panels) stays under ``cap``
    elements. A single level never splits (its buckets may interleave)."""
    stages = []
    cur: List[int] = []
    for li, lp in enumerate(plan.levels):
        cand = cur + [li]
        own, src = _stage_extent(plan, cand, offsets, rows_elems)
        need = (own[1] - own[0]) + int(src.sum())
        if cur and need > cap:
            stages.append(cur)
            cur = [li]
        else:
            cur = cand
    if cur:
        stages.append(cur)
    return stages


def _level_sns(lp):
    out = []
    for pb in lp.panels:
        out.append(pb.sns)
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _stage_extent(plan, level_ids, offsets, rows_elems):
    sns = np.concatenate([_level_sns(plan.levels[li]) for li in level_ids])
    if len(sns) == 0:
        return (0, 0), np.zeros(0, np.int64)
    lo = int(offsets[sns].min())
    hi = int((offsets[sns] + rows_elems[sns]).max())
    srcs = _stage_sources(plan, level_ids, sns)
    return (lo, hi), rows_elems[srcs] if len(srcs) else np.zeros(0, np.int64)


def _stage_sources(plan, level_ids, own_sns):
    own = set(own_sns.tolist())
    srcs = set()
    for li in level_ids:
        for ub in plan.levels[li].updates:
            for d in np.unique(ub.sds):
                if d >= 0 and d not in own:
                    srcs.add(int(d))
    return np.asarray(sorted(srcs), dtype=np.int64)


# the index tables that a rebased bucket carries as int32, as an int32
# plan's buckets do (the starts are rebased first)
_INT32_TABLES = {PanelBucketC: ("widths", "nbelow", "xcols", "xrows"),
                 UpdateBucketC: ("kw", "mrows", "tgt_lrow", "tgt_cpos",
                                 "rstart")}


def _rebased(bucket, **tables):
    """``dataclasses.replace(bucket, **tables)`` with the remaining index
    tables as int32 and FRESH, empty device caches (the original's
    ``_dev`` dicts may already hold its un-rebased tables)."""
    for name in _INT32_TABLES[type(bucket)]:
        v = getattr(bucket, name)
        if v is not None and name not in tables:
            tables[name] = v.astype(np.int32)
    caches = {f.name: {} for f in dataclasses.fields(bucket)
              if f.name.startswith("_dev")}
    return dataclasses.replace(bucket, **tables, **caches)


def _pack_runs(src_base, src_lo, src_len, packed: int, lo: int,
               hi: int) -> np.ndarray:
    """The copies that fill a stage buffer from the host factor, (buffer
    start, host start, length) each: the packed sources, those that lie
    back to back both in the buffer and in the host factor merged into
    one, then the own region."""
    runs = []
    for b, h, n in zip(src_base.tolist(), src_lo.tolist(),
                       src_len.tolist()):
        if runs and runs[-1][0] + runs[-1][2] == b \
                and runs[-1][1] + runs[-1][2] == h:
            runs[-1][2] += n
        else:
            runs.append([b, h, n])
    runs.append([packed, lo, hi - lo])
    return np.asarray(runs, dtype=np.int64).reshape(-1, 3)


def _pack(buf: np.ndarray, host: np.ndarray, st: _Stage) -> int:
    """Fill the head of a stage buffer from the host factor: the packed
    sources at their bases and the own region after them, zeros in the
    gaps between. Returns where the own region ends: the buffer's tail
    past it (the slack) must be zero too, which the caller sees to."""
    pos = 0
    for b, h, n in st.runs.tolist():
        buf[pos:b] = 0
        buf[b:b + n] = host[h:h + n]
        pos = b + n
    return pos


class _HostFactor:
    """A factor whose arrays of record lie in host memory. The device solve
    uploads them at its first call and keeps them (its solve graphs read
    them where they lie)."""

    _uploaded = None

    def _solve_device(self, b: np.ndarray) -> np.ndarray:
        if self._uploaded is None:
            self._uploaded = tuple(torch.as_tensor(h, device=self.device)
                                   for h in self._host_arrays())
        F = self._uploaded
        return device_solve(self, F[0], F[-1], b)


class StreamedCholeskyFactor(_HostFactor, CholeskyFactor):
    """A Cholesky factor of record in host memory (``L`` is a CPU tensor
    over ``_Lh``)."""

    def _host_arrays(self):
        return (self._Lh,)


class StreamedLUFactor(_HostFactor, LUFactor):
    """An LU factor of record in host memory (``Lx`` and ``Ux`` are CPU
    tensors over ``_host``)."""

    def _host_arrays(self):
        return self._host


class StreamingCholesky:
    """Out-of-core supernodal Cholesky: host-resident factor, stage-wise
    device execution on ``device`` (the CUDA device unless given). API
    mirrors ``spfx_torch.Cholesky``.

    The LU line (StreamingLU) shares every mechanism: the only deltas are
    twin host/device arrays, the U^T assembly scatter, and the LU branch
    of the walk."""

    lu = False

    def __init__(self, A: sp.spmatrix, config: Config = DEFAULT,
                 stage_elems: int = 1 << 27, sym=None, device=None):
        A = sp.csc_matrix(A)
        check_config(config)
        if config.layout != "contig":
            raise ValueError("streaming engine requires layout='contig'")
        self.config = config
        self.device = resolve_device(device)
        self.stage_elems = int(stage_elems)
        t0 = time.perf_counter()
        self.sym = sym if sym is not None else analyze(
            A, config, symmetrize=self.lu)
        self.analyze_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.plan = build_plan(self.sym, A, config, lu=self.lu,
                               idx_dtype=np.int64)
        # per-supernode element extent in the uniform layout (the plan's
        # own rows_sn is the layout of record — recomputing it here would
        # silently drift from build_plan's padding rules)
        self.rows_elems = self.plan.rows_sn * self.plan.strides
        self._build_stages()
        for st in self.stages:
            check_windows(self.stage_plan(st))
        self.plan_time = time.perf_counter() - t0
        self._graphs: dict = {}    # panel mode -> [_capture's graph, ...]
        self._pool = None          # the stages' shared graph memory pool
        self._bufs = None          # device stage buffers (card)
        self._pins = None          # pinned host staging buffers (card)
        # panel mode -> {"warmup_s", "capture_s", "launches"}, summed over
        # the stages at the first factorization of the mode
        self.captures: dict = {}
        self.stats: dict = {}      # the last factorization's times

    # ---------------- stage construction --------------------------------
    def _build_stages(self):
        plan, offsets = self.plan, self.plan.offsets
        parts = _stage_partition(plan, offsets, self.rows_elems,
                                 self.stage_elems)
        self.stages: List[_Stage] = []
        for level_ids in parts:
            sns = np.concatenate(
                [_level_sns(plan.levels[li]) for li in level_ids])
            if len(sns) == 0:
                continue
            lo = int(offsets[sns].min())
            hi = int((offsets[sns] + self.rows_elems[sns]).max())
            srcs = _stage_sources(plan, level_ids, sns)
            src_lo = offsets[srcs] if len(srcs) else np.zeros(0, np.int64)
            src_len = self.rows_elems[srcs] if len(srcs) \
                else np.zeros(0, np.int64)
            # pack sources preserving start mod ALIGN (superwindow
            # congruence, see _Stage.src_base), then place the own region
            # so its shift is a multiple of ALIGN too
            src_base = np.zeros(len(srcs), dtype=np.int64)
            cur = 0
            for k in range(len(srcs)):
                cur += (int(src_lo[k]) - cur) % ALIGN
                src_base[k] = cur
                cur += int(src_len[k])
            packed = cur + (lo - cur) % ALIGN
            base = np.zeros(plan.offsets.shape[0], dtype=np.int64)
            if len(srcs):
                base[srcs] = src_base
            own_off = packed - lo            # own region lands after packed
            levels = [self._rebase_level(plan.levels[li], sns, srcs, base,
                                         own_off, offsets)
                      for li in level_ids]
            # stage buffer: packed sources + own region + whatever padded
            # bucket tails / extend-add slabs / gather superwindows overrun
            # past it (globally those land on later panels; here they need
            # real slack). MUST be the plan's computed slack — it accounts
            # the aligned superwindow sizes ((mp+ext)*kp etc.); the module
            # SLACK floor alone lets end-of-buffer windows run past it.
            slk = plan.slack
            storage = packed + (hi - lo) + slk
            for lvl in levels:
                for pb in lvl.panels:
                    storage = max(storage, int(pb.slab_lo[0]) + slk
                                  + len(pb.widths) * (pb.cp + pb.rbp)
                                  * pb.cp)
                for ub in lvl.updates:
                    storage = max(storage, int(ub.slab_lo[0]) + slk
                                  + ub.slab_rows * ub.csp)
            self.stages.append(_Stage(
                levels, lo, hi, srcs, src_lo, src_len, src_base, packed,
                storage, _pack_runs(src_base, src_lo, src_len, packed, lo,
                                    hi)))

    def _rebase_level(self, lp, own_sns, srcs, src_base, own_off, offsets):
        panels, updates = [], []
        for pb in lp.panels:
            assert isinstance(pb, PanelBucketC)
            r = lambda a: np.where(a >= 0, a + own_off, -1).astype(np.int32)
            panels.append(_rebased(
                pb, diag_start=r(pb.diag_start),
                below_start=r(pb.below_start),
                slab_lo=(pb.slab_lo + own_off).astype(np.int32)))
        for ub in lp.updates:
            assert isinstance(ub, UpdateBucketC)
            # source windows: own-region descendants shift with the region;
            # packed descendants map to their packed offset
            d = ub.sds

            def remap(starts):
                valid = (d >= 0) & (starts >= 0)
                rel = starts.astype(np.int64) - \
                    np.where(valid, offsets[np.maximum(d, 0)], 0)
                in_own = np.isin(d, own_sns) & valid
                in_src = np.isin(d, srcs) & valid
                assert (valid <= (in_own | in_src)).all(), \
                    "update source panel missing from stage inputs"
                return np.where(
                    in_own, starts.astype(np.int64) + own_off,
                    np.where(in_src, src_base[np.maximum(d, 0)] + rel,
                             -1)).astype(np.int32)

            nb = _rebased(
                ub, src_start=remap(ub.src_start),
                head_start=(None if ub.head_start is None
                            else remap(ub.head_start)),
                slab_lo=(ub.slab_lo + own_off).astype(np.int32))
            nb.sds = ub.sds
            updates.append(nb)
        return LevelPlan(panels, updates)

    def stage_plan(self, st: _Stage) -> FactorPlan:
        """A stage as a plan over its own buffer (``storage`` values): its
        rebased levels, no assembly."""
        plan = self.plan
        return FactorPlan(n=plan.n, xsize=st.storage - plan.slack,
                          levels=st.levels,
                          assembly_idx=np.zeros(0, np.int64),
                          offsets=plan.offsets, flops=0.0,
                          strides=plan.strides, slack=plan.slack)

    # ---------------- execution -----------------------------------------
    def factorize(self, A: sp.spmatrix):
        from spfx_torch.utils.instrument import finish_factorize
        A = sp.csc_matrix(A)
        t0 = time.perf_counter()
        dtype = np.dtype(self.config.dtype)
        plan = self.plan
        hosts = [np.zeros(plan.storage, dtype=dtype)
                 for _ in range(2 if self.lu else 1)]
        Ap = A[self.sym.perm][:, self.sym.perm]
        hosts[0][plan.assembly_idx] = sp.tril(Ap).tocsc().data.astype(dtype)
        if self.lu:
            hosts[1][plan.assembly_idx_u] = \
                sp.tril(Ap.T, -1).tocsc().data.astype(dtype)
        mode = route.panel_mode()      # SPFX_PANEL_KERNEL, once a call
        self.stats = dict(stages=len(self.stages), assemble_s=
                          time.perf_counter() - t0, pack_s=0.0,
                          unpack_s=0.0, upload_ms=0.0, walk_ms=0.0,
                          download_ms=0.0)
        run = self._stage_card if self.device.type == "cuda" \
            else self._stage_host
        for si, st in enumerate(self.stages):
            run(si, st, hosts, mode)
        # the factor of record is HOST-resident (it may exceed device
        # memory / int32)
        if self.lu:
            f = StreamedLUFactor(A, self.sym, self.plan,
                                 *(torch.from_numpy(h) for h in hosts),
                                 self.config)
            f._host = tuple(hosts)
        else:
            f = StreamedCholeskyFactor(A, self.sym, self.plan,
                                       torch.from_numpy(hosts[0]),
                                       self.config)
            f._Lh = hosts[0]
        f.device = self.device
        return finish_factorize(self, f, t0)

    def _stage_host(self, si: int, st: _Stage, hosts, mode: str) -> None:
        """One stage on the CPU: an eager walk over a packed numpy buffer,
        then the own region back into the host factor."""
        t0 = time.perf_counter()
        bufs = [np.zeros(st.storage, dtype=h.dtype) for h in hosts]
        for buf, host in zip(bufs, hosts):
            _pack(buf, host, st)
        self.stats["pack_s"] += time.perf_counter() - t0
        walk_levels([torch.from_numpy(b) for b in bufs], st.levels, self.lu,
                    self.config, self.device, mode)
        own = st.hi - st.lo
        for buf, host in zip(bufs, hosts):
            host[st.lo:st.hi] = buf[st.packed:st.packed + own]

    def _buffers(self):
        """The device stage buffers and their pinned host twins, sized to
        the largest stage, made at the first factorization on the card."""
        if self._bufs is None:
            n = max(st.storage for st in self.stages)
            dt = _DTYPES[self.config.dtype]
            k = 2 if self.lu else 1
            self._bufs = [torch.zeros(n, dtype=dt, device=self.device)
                          for _ in range(k)]
            self._pins = [torch.zeros(n, dtype=dt, pin_memory=True)
                          for _ in range(k)]
        return self._bufs, self._pins

    def _stage_graph(self, si: int, st: _Stage, views, mode: str):
        """The stage's captured walk for ``mode``, capturing it (after an
        eager warm-up on whatever the buffer holds) at its first use; the
        stages share one memory pool and are always captured and replayed
        in stage order."""
        graphs = self._graphs.setdefault(mode, [])
        if si < len(graphs):
            return graphs[si]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()

        def walk(*arrays):
            walk_levels(list(arrays), st.levels, self.lu, self.config,
                        self.device, mode)

        graph, _, warm, cap, launches = _capture(
            self.device, walk, tuple(views), pool=self._pool)
        rec = self.captures.setdefault(
            mode, dict(warmup_s=0.0, capture_s=0.0, launches={}))
        rec["warmup_s"] += warm
        rec["capture_s"] += cap
        for name, v in launches.items():
            rec["launches"][name] = rec["launches"].get(name, 0) + v
        graphs.append(graph)
        return graph

    def _stage_card(self, si: int, st: _Stage, hosts, mode: str) -> None:
        """One stage on the card: pack the buffer's head into the pinned
        buffers, upload it and zero the tail on the device, replay the
        stage's graph, download the own region, synchronize, copy it into
        the host factor."""
        bufs, pins = self._buffers()
        views = [b[:st.storage] for b in bufs]
        graph = self._stage_graph(si, st, views, mode)
        t0 = time.perf_counter()
        for pin, host in zip(pins, hosts):
            end = _pack(pin.numpy(), host, st)
        self.stats["pack_s"] += time.perf_counter() - t0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        own = st.hi - st.lo
        ev[0].record()
        for v, pin in zip(views, pins):
            v[:end].copy_(pin[:end], non_blocking=True)
            v[end:].zero_()
        ev[1].record()
        graph.replay()
        ev[2].record()
        for v, pin in zip(views, pins):
            pin[st.packed:st.packed + own].copy_(
                v[st.packed:st.packed + own], non_blocking=True)
        ev[3].record()
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for pin, host in zip(pins, hosts):
            host[st.lo:st.hi] = pin.numpy()[st.packed:st.packed + own]
        self.stats["unpack_s"] += time.perf_counter() - t0
        for key, a, b in (("upload_ms", 0, 1), ("walk_ms", 1, 2),
                          ("download_ms", 2, 3)):
            self.stats[key] += ev[a].elapsed_time(ev[b])


class StreamingLU(StreamingCholesky):
    """Out-of-core unpivoted supernodal LU: twin host-resident L / U^T
    factors, stage-wise device execution."""

    lu = True
