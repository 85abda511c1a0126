"""Per-phase instrumentation and the post-factorization check.

Port of spfx/utils/instrument.py: the two runtime knobs of ``Config``.

- ``Config.profile``: per-phase wall times and the plan's schedule counters
  on stderr; with ``SPFX_PROFILE_DIR`` set, also a ``torch.profiler`` trace
  around the numeric factorization, written as a Chrome trace (loadable in
  Perfetto or chrome://tracing) under ``$SPFX_PROFILE_DIR/<phase>/``.
- ``Config.validate``: the scaled residual ``|Ax-b| / (|A| |x| + |b|)`` of
  the refined solve right after the factorization, kept on the factor as
  ``factor.residual``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch


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
