"""The port's recorder of spans and counters (spfx_torch.utils.instrument)
on the CPU: the span tree of a Cholesky and an LU factorization, the
counters of a refined solve, the ring's bound, the switch that turns it
off, the step stamps of the eager walk (host clock) and the factor they
leave unchanged, the spans on a torch.profiler timeline, and the counters
under many threads. The capture times of MegaSolver's graph are held on the
card."""

import sys
import threading

import numpy as np
import pytest
import torch

import spfx_torch
from spfx_torch import Config
from spfx_torch.io import generate
from spfx_torch.kernels.mega import MegaRunner, MegaSolver
from spfx_torch.utils import instrument
from spfx_torch.validate import synth_rhs

torch.set_num_threads(1)

GRID = 5


@pytest.fixture
def rec():
    """The process's recorder, emptied, and on again afterwards."""
    instrument.enable(True)
    instrument.clear()
    yield instrument
    instrument.enable(True)
    instrument.clear()


def _matrix(lu: bool):
    A = generate.laplacian_3d(GRID).tocsc()
    if lu:              # unsymmetric values on the symmetric pattern
        A = A.copy()
        A.data *= 1.0 + 0.1 * (A.indices > np.repeat(
            np.arange(A.shape[1]), np.diff(A.indptr)))
    return A


def _context(lu: bool, **kw):
    kind = spfx_torch.LU if lu else spfx_torch.Cholesky
    A = _matrix(lu)
    return kind(A, Config(**kw), device="cpu"), A


def _by_name(req):
    out = {}
    for s in req["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


@pytest.mark.parametrize("lu,pivot", [(False, False), (True, False),
                                      (True, True)],
                         ids=["chol", "lu", "lu_static_pivot"])
def test_span_tree_of_a_factorization(rec, lu, pivot):
    kw = dict(static_pivot=True) if pivot else {}
    ctx, A = _context(lu, validate=True, solve_backend="device", **kw)
    setup = [s["name"] for s in rec.snapshot()["setup"]]
    assert setup == ["spfx.analyze", "spfx.plan"]
    f = ctx.factorize(A)
    assert f.residual < 1e-8
    snap = rec.snapshot()
    # one request, the validate solve inside it
    assert [r["kind"] for r in snap["requests"]] == ["spfx.factorize"]
    req = snap["requests"][0]
    spans = _by_name(req)
    (top,) = spans["spfx.factorize"]
    assert top["parent"] is None and top["id"] == req["id"]
    assert all(s["start_ns"] <= s["end_ns"] for s in req["spans"])
    for name in ("spfx.entry.permute", "spfx.entry.copy", "spfx.replay",
                 "spfx.solve"):
        assert all(s["parent"] == top["id"] for s in spans[name]), name
    # the entry map folds the static pivot's rows in: one permute span
    assert len(spans["spfx.entry.permute"]) == 1
    assert len(spans["spfx.entry.copy"]) == 1
    (solve,) = spans["spfx.solve"]
    passes = spans["spfx.solve.pass"]
    assert all(s["parent"] == solve["id"] for s in
               passes + spans["spfx.refine.residual"])
    assert passes
    for name in ("spfx.solve.stage_in", "spfx.solve.stage_out"):
        assert [s["parent"] for s in spans[name]] == [s["id"] for s in
                                                      passes]
    # the spans lie inside their parents
    by_id = {s["id"]: s for s in req["spans"]}
    for s in req["spans"]:
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
    # the context's attributes come from the same clock reads
    want = {s["name"]: s["ms"] / 1e3 for s in snap["setup"]}
    assert ctx.analyze_time == pytest.approx(want["spfx.analyze"])
    assert ctx.plan_time == pytest.approx(want["spfx.plan"])
    assert 0 < ctx.factorize_time <= top["ms"] / 1e3
    # the bytes copied are A's values, once, gathered on the device
    assert req["counters"]["entry_mapped"] == 1
    assert req["counters"]["entry_bytes"] == A.nnz * ctx.dtype.itemsize


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_plan_and_request_carry_the_arithmetic(rec, lu, dtype):
    ctx, A = _context(lu, dtype=dtype)
    (plan,) = [s for s in rec.snapshot()["setup"]
               if s["name"] == "spfx.plan"]
    size = {"float32": 4, "float64": 8, "complex64": 8, "complex128": 16}
    arrays = 2 if lu else 1
    assert plan["attrs"] == {
        "dtype": dtype, "itemsize": size[dtype], "flops": ctx.plan.flops,
        "factor_values": ctx.plan.storage,
        "factor_bytes": ctx.plan.storage * size[dtype] * arrays}
    ctx.factorize(A)
    (req,) = rec.snapshot()["requests"]
    (top,) = _by_name(req)["spfx.factorize"]
    assert top["attrs"] == {"dtype": dtype}


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_counters_of_a_refined_solve(rec, lu):
    ctx, A = _context(lu, solve_backend="device")
    f = ctx.factorize(A)
    B = np.random.default_rng(3).standard_normal((A.shape[0], 4))
    f.solve(B)
    f.solve(B[:, 0], refine=0)
    snap = rec.snapshot()
    c = snap["counters"]
    assert c["solve_requests"] == 2
    assert c["refine_sweeps"] == c["solve_passes"] - c["solve_requests"]
    assert c.get("refine_capped", 0) == 0
    assert "replays" not in c           # graph replays: the card's
    solves = [r for r in snap["requests"] if r["kind"] == "spfx.solve"]
    assert len(solves) == 2
    for r in solves:
        spans = _by_name(r)
        k = r["counters"]
        assert k["solve_passes"] == len(spans["spfx.solve.pass"])
        assert k.get("refine_sweeps", 0) == k["solve_passes"] - 1
        # a residual before each sweep, and one that met the tolerance
        assert len(spans.get("spfx.refine.residual", ())) == (
            k.get("refine_sweeps", 0) + 1 if r is solves[0] else 0)
        assert r["device"] == []       # no device intervals on the CPU


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_refine_capped(rec, lu):
    """A solve that makes every sweep it may with no residual under the
    tolerance is counted as capped."""
    ctx, A = _context(lu, refine_iters=1, refine_tol=0.0)
    f = ctx.factorize(A)
    f.solve(synth_rhs(A))
    c = rec.snapshot()["counters"]
    assert (c["solve_requests"], c["solve_passes"], c["refine_sweeps"],
            c["refine_capped"]) == (1, 2, 1, 1)


def test_ring_is_bounded():
    r = instrument.Recorder(ring=4)
    for i in range(10):
        with r.span("spfx.solve", i=i):
            with r.span("spfx.solve.pass"):
                r.count("solve_passes")
    with r.span("spfx.analyze"):
        pass
    snap = r.snapshot()
    assert [q["spans"][-1]["attrs"]["i"] for q in snap["requests"]] == [
        6, 7, 8, 9]
    assert all(q["counters"] == {"solve_passes": 1}
               for q in snap["requests"])
    assert snap["counters"] == {"solve_passes": 10}
    assert [s["name"] for s in snap["setup"]] == ["spfx.analyze"]
    # a span outside any request records into no request
    with r.span("spfx.replay"):
        r.count("replays")
    assert len(r.snapshot()["requests"]) == 4
    assert r.snapshot()["counters"]["replays"] == 1
    r.clear()
    assert r.snapshot() == {"counters": {}, "setup": [], "requests": [],
                            "steps": {}}


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_off_records_nothing(rec, lu):
    rec.enable(False)
    assert rec.span("a") is rec.span("b")
    ctx, A = _context(lu)
    f = ctx.factorize(A)
    f.solve(synth_rhs(A))
    assert rec.snapshot() == {"counters": {}, "setup": [], "requests": [],
                              "steps": {}}
    # the contexts' times are read all the same
    assert ctx.analyze_time > 0 and ctx.plan_time > 0
    assert ctx.factorize_time > 0
    # a walk made while off has no stamps
    assert rec.stamps(3, "cpu") is None
    runner = MegaRunner(ctx.plan, lu=lu, config=ctx.config, device="cpu")
    vals = ctx.entry_values(A)
    runner.run(*(vals if lu else (vals,)))
    assert rec.snapshot()["steps"] == {}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_stamps_leave_the_factor_unchanged(rec, lu, dtype):
    ctx, A = _context(lu, dtype=dtype)
    on = ctx.factorize(A)
    assert rec.snapshot()["steps"]
    rec.enable(False)
    off = ctx.factorize(A)
    arrays = (lambda f: (f.Lx, f.Ux)) if lu else (lambda f: (f.L,))
    for a, b in zip(arrays(on), arrays(off)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_cpu_stamps_are_host_clock(rec, lu):
    from spfx_torch.kernels import route
    ctx, A = _context(lu)
    ctx.factorize(A)
    steps = rec.snapshot()["steps"]
    assert list(steps) == [route.panel_mode()]
    st = steps[route.panel_mode()]
    assert st["clock"] == "host"
    assert len(st["levels"]) == len(ctx.plan.levels)
    assert all(len(lv) == 2 and min(lv) >= 0 for lv in st["levels"])
    assert st["assembly_ms"] >= 0
    assert st["ut_ms"] == pytest.approx(sum(u for u, _ in st["levels"]))
    assert st["pc_ms"] == pytest.approx(sum(p for _, p in st["levels"]))
    (req,) = rec.snapshot()["requests"]
    (replay,) = _by_name(req)["spfx.replay"]
    # the walk's intervals lie inside the replay span
    assert st["assembly_ms"] + st["ut_ms"] + st["pc_ms"] <= replay["ms"]
    # a walk of the runner's own, outside a factorization
    stamps = rec.stamps(len(ctx.plan.levels), "cpu")
    vals = ctx.entry_values(A)
    ctx._runner._once(*(vals if lu else (vals,)), stamps=stamps)
    assert len(stamps.marks) == stamps.n == 2 + 2 * len(ctx.plan.levels)
    assert stamps.resolve()["clock"] == "host"
    assert rec.stamps(2, "cpu").resolve() is None    # no marks yet


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_spans_on_the_profiler_timeline(rec, lu):
    from torch.profiler import ProfilerActivity, profile, record_function
    ctx, A = _context(lu, solve_backend="device")
    ctx.factorize(A)              # outside the profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            f = ctx.factorize(A)
            f.solve(synth_rhs(A))
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append((e.time_range.start,
                                              e.time_range.end))
    (caller,) = ranges["caller"]
    for name in ("spfx.factorize", "spfx.entry.permute", "spfx.entry.copy",
                 "spfx.replay", "spfx.solve", "spfx.solve.pass",
                 "spfx.solve.stage_in", "spfx.solve.stage_out",
                 "spfx.refine.residual"):
        assert name in ranges, name
        assert all(caller[0] <= s and e <= caller[1]
                   for s, e in ranges[name]), name
    (fac,) = ranges["spfx.factorize"]
    assert all(fac[0] <= s and e <= fac[1]
               for s, e in ranges["spfx.entry.permute"])
    reqs = rec.snapshot()["requests"]
    assert [r["profiled"] for r in reqs] == [False, True, True]


def test_counters_under_many_threads():
    """Counters and requests from more threads than cores, with a short
    switch interval: no count is lost and each thread's requests keep
    their own spans."""
    r = instrument.Recorder(ring=10_000)
    per, threads = 300, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with r.span("spfx.solve"):
                    with r.span("spfx.solve.pass"):
                        r.count("solve_passes")
                r.count("outside")
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    snap = r.snapshot()
    assert snap["counters"] == {"solve_passes": per * threads,
                                "outside": per * threads}
    assert len(snap["requests"]) == per * threads
    for q in snap["requests"]:
        assert [s["name"] for s in q["spans"]] == ["spfx.solve.pass",
                                                   "spfx.solve"]
        assert q["spans"][0]["parent"] == q["id"]
        assert q["counters"] == {"solve_passes": 1}


@pytest.mark.card
@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_solve_capture_times_are_kept(rec, lu):
    """On the card a device solve's first call captures its graph: the
    solver keeps the capture's times and the set-up span carries them; a
    pass records the graph's device interval."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card)")
    kind = spfx_torch.LU if lu else spfx_torch.Cholesky
    A = _matrix(lu)
    ctx = kind(A, Config(solve_backend="device"), device="cuda")
    f = ctx.factorize(A)
    f.solve(np.ones((A.shape[0], 2)))
    cap = ctx._solver.captures[2]
    assert isinstance(ctx._solver, MegaSolver)
    assert cap["warmup_s"] > 0 and cap["capture_s"] > 0
    snap = rec.snapshot()
    (sc,) = [s for s in snap["setup"] if s["name"] == "spfx.solve.capture"]
    assert sc["attrs"]["warmup_s"] == cap["warmup_s"]
    assert sc["attrs"]["capture_s"] == cap["capture_s"]
    (mode, st), = snap["steps"].items()
    assert st["clock"] == "device"
    assert len(st["levels"]) == len(ctx.plan.levels)
    solve = snap["requests"][-1]
    assert solve["kind"] == "spfx.solve"
    assert [d["name"] for d in solve["device"]] == \
        ["spfx.solve.graph"] * solve["counters"]["solve_passes"]
    assert all(d["ms"] > 0 for d in solve["device"])
