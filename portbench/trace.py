"""The device's side of a traced slice of the window, from
``torch.profiler`` (CPU and CUDA activity): each device operation's
interval and name, the benchmark's own host spans, the busy and idle time
of the device, and the longest idle gaps named by the host span that was
open around them."""

from __future__ import annotations

from collections import defaultdict

# the host spans the benchmark records, the innermost one naming a gap
SPANS = ("request", "factorize", "refine", "entry_values", "replay",
         "solve_pass")


def events(prof):
    """(device ops [(name, start_us, end_us)], spans [(name, s, e)]) of a
    stopped profiler."""
    from torch.autograd import DeviceType
    ops, spans = [], []
    for e in prof.events():
        t = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                ops.append(t)
        elif e.name in SPANS:
            spans.append(t)
    return ops, spans


def union(intervals):
    """The disjoint union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(ops, spans, top: int = 10) -> dict:
    """Over the slice that the "request" spans cover: ``window_s``,
    ``busy_s`` (the union of the device ops' intervals inside it),
    ``kernel_s`` (seconds by op name), ``device_ops`` (the ``top`` names
    by seconds) and ``idle_gaps`` (the ``top`` longest gaps, each named
    by the innermost span open at its middle, "harness" where none is)."""
    req = [(s, e) for n, s, e in spans if n == "request"]
    if not req:
        return {}
    w0, w1 = min(s for s, _ in req), max(e for _, e in req)
    busy = union((max(s, w0), min(e, w1)) for _, s, e in ops
                 if e > w0 and s < w1)
    by_name = defaultdict(float)
    for n, s, e in ops:
        if e > w0 and s < w1:
            by_name[n] += (min(e, w1) - max(s, w0)) / 1e6
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        open_ = [(se - ss, n) for n, ss, se in spans if ss <= mid <= se]
        named.append([min(open_)[1] if open_ else "harness", (e - s) / 1e6])
    named.sort(key=lambda g: -g[1])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "kernel_s": dict(by_name),
            "device_ops": [[n[:120], v] for n, v in ranked[:top]],
            "idle_gaps": named[:top]}
