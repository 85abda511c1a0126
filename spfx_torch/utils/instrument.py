"""Instrumentation: the recorder of spans and counters, per-phase profiling
and the post-factorization check.

The recorder (``span``, ``timed``, ``count``, ``snapshot``, ``enable``,
``clear``) is on by default and cheap enough to stay on: a flight recorder
of process-wide counters, a bounded ring of the most recent requests and
the set-up spans, read by ``snapshot()`` as plain Python data.

- A span has a name, attributes, its start and end (``perf_counter_ns``),
  its parent (the innermost span open on the thread) and its request. A
  request is a top-level ``spfx.factorize`` or ``spfx.solve`` span; a span
  of either name opened inside another request (the validate solve inside
  a factorization) belongs to that request. A request's record (its spans,
  the counts made while it was open, whether a ``torch.profiler`` was
  recording when it began, and its device intervals: CUDA event pairs,
  resolved when ``snapshot()`` is called) enters the ring when it ends.
  The set-up spans (``SETUP``: host analysis, plan, graph captures) go to
  a list of their own, wherever they open.
- While a ``torch.profiler`` records, each span also opens a
  ``record_function`` of its name, so the program's spans lie on the
  profiler's timeline beside the device's operations.
- ``Stamps``: the step stamps of one level walk (the start, after the
  assembly, after each level's update buckets and after its panel
  buckets). In a CUDA graph they are timing events captured as
  event-record nodes, which each replay records again; on the CPU the
  eager walk is synchronous and they are host clock reads.
- ``enable(False)`` turns recording off: ``span`` then returns one shared
  no-op object, ``count`` returns at once, and a walk or graph made while
  off has no stamps. ``timed`` still reads the clock, since the contexts'
  ``analyze_time``, ``plan_time`` and ``factorize_time`` take their values
  from it.

Port of spfx/utils/instrument.py's two runtime knobs of ``Config``:

- ``Config.profile``: per-phase wall times and the plan's schedule counters
  on stderr; with ``SPFX_PROFILE_DIR`` set, also a ``torch.profiler`` trace
  around the numeric factorization, written as a Chrome trace (loadable in
  Perfetto or chrome://tracing) under ``$SPFX_PROFILE_DIR/<phase>/``.
- ``Config.validate``: the scaled residual ``|Ax-b| / (|A| |x| + |b|)`` of
  the refined solve right after the factorization, kept on the factor as
  ``factor.residual``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time

import torch

REQUESTS = ("spfx.factorize", "spfx.solve")
SETUP = ("spfx.analyze", "spfx.plan", "spfx.capture", "spfx.solve.capture")
RING = 1024


class _Noop:
    """The span of a recorder that is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def device_pair(self):
        return None


_NOOP = _Noop()


class Span:
    """One span; ``rec`` None reads the clock and records nothing."""
    __slots__ = ("rec", "name", "attrs", "start", "end", "id", "parent",
                 "request", "_rf")

    def __init__(self, rec, name: str, attrs: dict):
        self.rec = rec
        self.name = name
        self.attrs = attrs
        self._rf = None

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            stack = rec._stack()
            parent = stack[-1] if stack else None
            self.id = next(rec._ids)
            self.parent = None if parent is None else parent.id
            if parent is not None:
                self.request = parent.request
            elif self.name in REQUESTS:
                self.request = rec._open_request(self)
            else:
                self.request = None
            stack.append(self)
            if torch.autograd._profiler_enabled():
                self._rf = torch.autograd.profiler.record_function(self.name)
                self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        rec = self.rec
        if rec is not None:
            if self._rf is not None:
                self._rf.__exit__(None, None, None)
            rec._stack().pop()
            rec._close(self)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def device_pair(self):
        """(start, end) timing events from the recorder's pool, their
        interval kept in this span's request: the caller records them on
        the device around the work. None on the CPU or outside a
        request."""
        if self.rec is None or self.request is None:
            return None
        pair = self.rec._pair()
        self.request["device"].append([self.name, self.id, pair])
        return pair

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def start_s(self) -> float:
        """The start on ``time.perf_counter``'s scale."""
        return self.start / 1e9


class Stamps:
    """The step stamps of one level walk on ``device``, ``levels`` levels:
    2 + 2 * levels marks (the start, after the assembly, after each level's
    update buckets, after its panel buckets). On a CUDA device a mark is
    recorded only while the stream is capturing (an eager warm-up leaves
    them alone), as an external timing event: an event-record node of the
    graph, so the stamps hold the graph's most recent replay. On the CPU a
    mark is a host clock read."""

    def __init__(self, levels: int, device):
        self.n = 2 + 2 * levels
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True,
                                            external=True)
                           for _ in range(self.n)]
            for e in self.events:
                e.record()          # created here, not inside the capture

    def __call__(self) -> None:
        if not self.cuda:
            self.marks.append(time.perf_counter_ns())
        elif torch.cuda.is_current_stream_capturing():
            self.events[len(self.marks)].record(
                torch.cuda.current_stream())
            self.marks.append(None)

    def resolve(self) -> dict | None:
        """{"clock", "assembly_ms", "ut_ms", "pc_ms", "levels": [(ut_ms,
        pc_ms), ...]}; None unless every mark was made. On the card, call
        after the device has finished the replay."""
        if len(self.marks) != self.n:
            return None
        if self.cuda:
            ms = [a.elapsed_time(b) for a, b in zip(self.events,
                                                    self.events[1:])]
        else:
            ms = [(b - a) / 1e6 for a, b in zip(self.marks, self.marks[1:])]
        levels = list(zip(ms[1::2], ms[2::2]))
        return {"clock": "device" if self.cuda else "host",
                "assembly_ms": ms[0],
                "ut_ms": sum(u for u, _ in levels),
                "pc_ms": sum(p for _, p in levels),
                "levels": levels}


class Recorder:
    """Process-wide counters, the ring of the ``ring`` most recent
    requests, the set-up spans (the ``ring`` most recent) and the step
    stamps of the latest walk of each panel mode."""

    def __init__(self, ring: int = RING):
        self.on = True
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._counters = collections.Counter()
        self._requests = collections.deque(maxlen=ring)
        self._setup = collections.deque(maxlen=ring)
        self._steps = {}            # panel mode -> Stamps
        self._free = []             # timing events for device pairs

    # -- recording ------------------------------------------------------

    def span(self, name: str, **attrs):
        """A span as a context manager (the shared no-op when off)."""
        if not self.on:
            return _NOOP
        return Span(self, name, attrs)

    def timed(self, name: str, **attrs) -> Span:
        """A span that reads the clock even when the recorder is off (its
        ``seconds`` and ``start_s`` feed the contexts' attributes)."""
        return Span(self if self.on else None, name, attrs)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``, and to the open request's."""
        if not self.on:
            return
        stack = self._stack()
        with self._lock:
            self._counters[name] += n
        if stack and stack[-1].request is not None:
            stack[-1].request["counters"][name] += n

    def stamps(self, levels: int, device) -> Stamps | None:
        """A walk's ``Stamps``, None when off."""
        return Stamps(levels, device) if self.on else None

    def note_steps(self, mode: str, stamps: Stamps | None) -> None:
        """``stamps`` are now the latest walk (or replay) of ``mode``."""
        if self.on and stamps is not None:
            with self._lock:
                self._steps.pop(mode, None)
                self._steps[mode] = stamps

    # -- switches -------------------------------------------------------

    def enable(self, on: bool = True) -> None:
        """Turn recording on (the default) or off."""
        self.on = bool(on)

    def clear(self) -> None:
        """Empty the ring, the set-up spans, the counters and the steps."""
        with self._lock:
            for r in self._requests:
                self._release(r)
            self._requests.clear()
            self._setup.clear()
            self._counters.clear()
            self._steps.clear()

    # -- reading --------------------------------------------------------

    def snapshot(self) -> dict:
        """{"counters", "setup", "requests", "steps"} as plain data. Waits
        for the device first, then resolves the device intervals and the
        step stamps (the latest replay of each mode)."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        with self._lock:
            reqs = list(self._requests)
            for r in reqs:
                self._resolve(r)
            out = {"counters": dict(self._counters),
                   "setup": [_span_dict(s) for s in self._setup],
                   "requests": [_request_dict(r) for r in reqs],
                   "steps": {}}
            steps = list(self._steps.items())
        for mode, st in steps:
            got = st.resolve()
            if got is not None:
                out["steps"][mode] = got
        return out

    # -- internals ------------------------------------------------------

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _open_request(self, span: Span) -> dict:
        return {"id": span.id, "kind": span.name, "spans": [],
                "counters": collections.Counter(), "device": [],
                "profiled": torch.autograd._profiler_enabled()}

    def _close(self, span: Span) -> None:
        rec = (span.name, span.id, span.parent, span.start, span.end,
               span.attrs)
        if span.name in SETUP:
            with self._lock:
                self._setup.append(rec)
            return
        req = span.request
        if req is None:
            return
        req["spans"].append(rec)
        if span.parent is None:
            with self._lock:
                if len(self._requests) == self._requests.maxlen:
                    self._release(self._requests[0])
                self._requests.append(req)

    def _pair(self):
        with self._lock:
            if len(self._free) >= 2:
                return self._free.pop(), self._free.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _resolve(self, req: dict) -> None:
        for d in req["device"]:
            if isinstance(d[2], tuple):
                e0, e1 = d[2]
                d[2] = e0.elapsed_time(e1)
                self._free += [e0, e1]

    def _release(self, req: dict) -> None:
        for d in req["device"]:
            if isinstance(d[2], tuple):
                self._free += list(d[2])
                d[2] = None


def _span_dict(s) -> dict:
    name, sid, parent, start, end, attrs = s
    return {"name": name, "id": sid, "parent": parent, "start_ns": start,
            "end_ns": end, "ms": (end - start) / 1e6, "attrs": dict(attrs)}


def _request_dict(r: dict) -> dict:
    return {"id": r["id"], "kind": r["kind"], "profiled": r["profiled"],
            "spans": [_span_dict(s) for s in r["spans"]],
            "counters": dict(r["counters"]),
            "device": [{"name": n, "span": sid, "ms": ms}
                       for n, sid, ms in r["device"] if ms is not None]}


def plan_attrs(plan, dtype: torch.dtype, arrays: int) -> dict:
    """The ``spfx.plan`` span's attributes: the context's arithmetic and
    the work its plan holds (operations of one factorization, the length
    of each of its ``arrays`` flat value arrays and their bytes)."""
    values = int(plan.storage)
    return {"dtype": str(dtype).removeprefix("torch."),
            "itemsize": dtype.itemsize, "flops": float(plan.flops),
            "factor_values": values,
            "factor_bytes": values * dtype.itemsize * arrays}


RECORDER = Recorder()
span = RECORDER.span
timed = RECORDER.timed
count = RECORDER.count
snapshot = RECORDER.snapshot
enable = RECORDER.enable
clear = RECORDER.clear
stamps = RECORDER.stamps
note_steps = RECORDER.note_steps


# -- Config.profile and Config.validate ---------------------------------


@contextlib.contextmanager
def profile_scope(config, phase: str):
    """A torch.profiler trace around a phase when ``config.profile`` is set
    and SPFX_PROFILE_DIR names a directory; the device's kernels are in it
    when a CUDA device is there."""
    trace_dir = os.environ.get("SPFX_PROFILE_DIR")
    if not (config.profile and trace_dir):
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = os.path.join(trace_dir, phase)
    os.makedirs(out, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        out, f"{phase}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def finish_factorize(ctx, factor, t0: float):
    """Wait for the device, record the factorization's wall time since
    ``t0`` on ``ctx``, then honour ``config.profile`` (timing lines and,
    once per context, the plan's schedule counters on stderr) and
    ``config.validate`` (the refined solve's scaled residual as
    ``factor.residual``, with a warning above 1e-8)."""
    config = ctx.config
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    ctx.factorize_time = time.perf_counter() - t0
    if config.profile:
        print(f"[spfx_torch profile] analyze {ctx.analyze_time:.3f}s  "
              f"plan {ctx.plan_time:.3f}s  "
              f"factorize {ctx.factorize_time:.3f}s  "
              f"({ctx.plan.flops / max(ctx.factorize_time, 1e-12) / 1e9:.1f}"
              " GFLOP/s)", file=sys.stderr, flush=True)
        # schedule-shape counters, once per plan
        if not getattr(ctx, "_stats_printed", False):
            ctx._stats_printed = True
            from spfx_torch.plan.schedule import plan_stats
            st = plan_stats(ctx.plan)
            census = st.pop("class_census")
            print("[spfx_torch profile] " + "  ".join(
                f"{k}={v}" for k, v in st.items()),
                file=sys.stderr, flush=True)
            print("[spfx_torch profile] top classes (key x chunks): "
                  + "  ".join(f"{k}x{c}" for k, c in census),
                  file=sys.stderr, flush=True)
    if config.validate:
        from spfx_torch.validate import scaled_residual, synth_rhs
        b = synth_rhs(factor.A)
        t1 = time.perf_counter()
        x = factor.solve(b)
        solve_t = time.perf_counter() - t1
        factor.residual = scaled_residual(factor.A, x, b)
        if config.profile:
            print(f"[spfx_torch profile] solve {solve_t:.3f}s  "
                  f"residual {factor.residual:.3e}",
                  file=sys.stderr, flush=True)
        if not factor.residual < 1e-8:
            print(f"[spfx_torch] WARNING: scaled residual "
                  f"{factor.residual:.3e} exceeds 1e-8 validation gate",
                  file=sys.stderr, flush=True)
    return factor
