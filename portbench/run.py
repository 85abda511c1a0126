"""Run one cell of the benchmark and print its result line.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (a workload of ``BENCHMARK.json``) names a configuration, whose
file gives the driver, the input family and the program's settings, and a
traffic mix. A run sets up (the program's context and the warm requests
that build and capture everything the mix uses), then sends requests in a
closed loop, one client, for ``--seconds``, then judges a sample of the
window's answers against the plain reference (``portbench.reference``).
With ``--trace 1`` the program's layers are timed by spans set from this
package, and ``torch.profiler`` records a short slice of the window.

Standard output ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` (``busy_s`` and
``window_s`` of the traced slice with ``--trace 1``), ``breakdown`` (with
``--trace 1``), ``card`` and, last, ``checks``: each number compared beside
its limit, which also end standard error.

A run needs a CUDA device: without one, or without as many as the cell
asks for, it prints no result and exits non-zero. It also exits non-zero,
without a result, if the JAX package or JAX itself has been imported into
the process by the end.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
import traceback

from portbench import spec as specs

FORBIDDEN = ("jax", "jaxlib", "flax", "spfx")


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def merge(base: dict, patch: dict) -> dict:
    """``base`` with ``patch``'s keys set, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in patch.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def forbidden_modules() -> list:
    """The modules whose top-level name, compared whole, is JAX's, Flax's
    or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None, t0: float | None = None, device=None, roots=None,
         spec: dict | None = None, patch: dict | None = None) -> int:
    """Run the cell that ``argv`` names; returns the exit code. The keyword
    arguments are for tests: ``device`` skips the look for a card and runs
    there (the CPU), ``roots`` are searched for the named files before this
    package, ``spec`` stands for BENCHMARK.json and ``patch`` is merged
    into the configuration."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    import torch
    if device is None and not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    spec = specs.load_spec() if spec is None else spec
    work, conf = specs.cell(spec, args.workload)
    if device is None:
        if torch.cuda.device_count() < work["chips"]:
            print(f"portbench: {args.workload} needs {work['chips']} "
                  f"devices, {torch.cuda.device_count()} found",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    with open(os.path.join(specs.ROOT, conf["file"])) as fh:
        config = merge(json.load(fh), patch or {})
    mix = specs.load_json("traffic", work["traffic"], roots)
    driver = specs.load_module("drivers", config["driver"], roots)
    trace = bool(args.trace)
    cell = driver.Cell(config, mix, args.seed, device, spans=trace,
                       roots=roots)
    if trace and cuda:
        _warm_profiler()
    cell.setup()
    setup_s = time.perf_counter() - t0

    w = window(cell, args.seconds, mix["profile_requests"] if trace else 0,
               cuda)
    peak = 0
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    obs = dict(setup_s=setup_s, window_s=w["window_s"],
               request_s=w["times"], attempted=w["attempted"],
               completed=len(w["times"]), failed=w["failed"], mix=mix,
               **cell.observations())
    sliced = {}
    if w["profile"] is not None:
        from portbench import trace as tr
        sliced = tr.summarize(*tr.events(w["profile"]))
        obs["trace"] = dict(sliced, requests=w["profiled"])
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in specs.metrics_of(spec, section, args.workload):
        value = specs.load_module("metrics", m["name"], roots).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # judged once the window has closed and the peak has been read
    found = cell.check() if w["failed"] == 0 and w["times"] else {}
    cell.release()
    checks = {k: {"value": v, "limit": config["limits"][k]}
              for k, v in found.items()}
    correct = (w["failed"] == 0 and bool(w["times"]) and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}; the benchmark measures "
              "the PyTorch port alone", file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda
           else device.type,
           "count": work["chips"], "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": w["attempted"],
            "failed": w["failed"], "metrics": metrics, "device": dev}
    if sliced:
        dev["busy_s"] = sliced["busy_s"]
        dev["window_s"] = sliced["window_s"]
        line["breakdown"] = {"device_ops": sliced["device_ops"],
                             "idle_gaps": sliced["idle_gaps"]}
    line["card"] = card_line() if cuda else device.type
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def window(cell, seconds: float, profile_requests: int, cuda: bool) -> dict:
    """The measured window: requests in a closed loop, one client, until
    ``seconds`` have passed. With ``profile_requests`` the profiler records
    that many requests from a quarter of the way in (the window waits for
    the last of them). A request that raises ends the window."""
    from torch.profiler import record_function
    times, attempted, failed = [], 0, 0
    prof, sliced, profiled = None, None, 0
    tw0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter()
        if prof is not None and profiled == profile_requests:
            prof.stop()
            prof = None
        if now - tw0 >= seconds and prof is None:
            break
        if profile_requests and sliced is None and now - tw0 >= 0.25 * \
                seconds:
            prof = sliced = _profiler(cuda)
            prof.start()
        attempted += 1
        t = time.perf_counter()
        try:
            with record_function("request"):
                cell.request(i, profiled=prof is not None)
        except Exception:   # the program's failure ends the window
            traceback.print_exc()
            failed += 1
            if prof is not None:
                prof.stop()
            break
        times.append(time.perf_counter() - t)
        profiled += prof is not None
        i += 1
    return dict(times=times, attempted=attempted, failed=failed,
                window_s=time.perf_counter() - tw0, profile=sliced,
                profiled=profiled)


def _profiler(cuda: bool):
    """A torch.profiler over the host and, on the card, the device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def _warm_profiler() -> None:
    """Start the profiler's device tracing once before the window, so that
    its own start-up is set-up time."""
    import torch
    with _profiler(True):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
