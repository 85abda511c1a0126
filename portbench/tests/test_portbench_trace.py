"""The metrics that read the program's own recorder
(``spfx_torch.utils.instrument``, through ``portbench.recorder``): in a
traced run on the CPU each one whose clock is the host's is in the line,
the step and solve-graph readers (device clock) and the capture reader (no
graph on the CPU) find nothing, an untraced line carries none of them, and
each reader's arithmetic on a recorder's snapshot."""

import pytest

from portbench import recorder
from portbench import spec as specs

SPEC = specs.load_spec()
NEW = ("entry_permute_ms", "entry_copy_ms", "assembly_ms", "ut_step_ms",
       "pc_step_ms", "solve_graph_ms", "solve_stage_ms",
       "refine_residual_ms", "refine_sweeps", "setup_analyze_s",
       "setup_plan_s", "setup_capture_s")
# read from the device's clock, or from graph captures: none on the CPU
DEVICE = {"assembly_ms", "ut_step_ms", "pc_step_ms", "solve_graph_ms",
          "setup_capture_s"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def _listed(workload):
    return {m["name"] for m in specs.metrics_of(SPEC, "per_layer", workload)}


@pytest.fixture
def fresh():
    from spfx_torch.utils import instrument
    instrument.enable(True)
    instrument.clear()
    yield instrument
    instrument.clear()


@pytest.mark.parametrize("workload", CELLS)
def test_traced_line_has_the_host_clock_metrics(run_cell, fresh, workload):
    want = _listed(workload) & set(NEW)
    assert want, workload
    rc, line = run_cell(workload, trace=1)
    assert rc == 0 and line["correct"] is True
    got = set(line["metrics"]) & set(NEW)
    assert got == want - DEVICE
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["setup_analyze_s"] > 0 and m["setup_plan_s"] > 0
    if "entry_permute_ms" in want:
        # the program's two spans lie inside the benchmark's wrapper
        assert 0 < m["entry_permute_ms"] + m["entry_copy_ms"] <= \
            m["entry_values_ms"]
    else:
        assert m["refine_sweeps"] + 1 == m["solve_passes"]
        assert 0 < m["solve_stage_ms"] < m["solve_pass_ms"]
        assert m["refine_residual_ms"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_line_has_none_of_them(run_cell, fresh, workload):
    rc, line = run_cell(workload, trace=0)
    assert rc == 0 and line["correct"] is True
    assert not set(line["metrics"]) & set(NEW)


def test_every_new_metric_lists_its_cells():
    for m in SPEC["per_layer"]:
        if m["name"] in NEW:
            cells = m["workloads"]
            if m["moves"] == "setup_s":
                assert cells == CELLS
            else:
                ops = {w["traffic"] for w in SPEC["workloads"]
                       if w["name"] in cells}
                assert ops == ({"refactor"} if m["moves"] == "factorize_ms"
                               else {"solve16"}), m["name"]


def _read(name, obs):
    return specs.load_module("metrics", name).read(obs)


def _span(name, ms, sid=0, parent=None, attrs=None):
    return {"name": name, "id": sid, "parent": parent, "start_ns": 0,
            "end_ns": int(ms * 1e6), "ms": ms, "attrs": attrs or {}}


def _snap():
    fac = [{"id": i, "kind": "spfx.factorize", "profiled": i == 3,
            "counters": {}, "device": [],
            "spans": [_span("spfx.entry.permute", 10.0 + i),
                      _span("spfx.entry.copy", 1.0),
                      _span("spfx.factorize", 100.0)]} for i in range(4)]
    sol = [{"id": 10 + i, "kind": "spfx.solve", "profiled": False,
            "counters": {"solve_passes": 2, "refine_sweeps": 1},
            "device": [{"name": "spfx.solve.graph", "span": 1, "ms": 4.0},
                       {"name": "spfx.solve.graph", "span": 2, "ms": 6.0}],
            "spans": [_span("spfx.solve.pass", 20.0),
                      _span("spfx.solve.pass", 20.0),
                      _span("spfx.solve.stage_in", 3.0),
                      _span("spfx.solve.stage_out", 1.0),
                      _span("spfx.solve.stage_in", 3.0),
                      _span("spfx.solve.stage_out", 1.0),
                      _span("spfx.refine.residual", 7.0),
                      _span("spfx.refine.residual", 5.0)]}
           for i in range(2)]
    setup = [_span("spfx.analyze", 2000.0), _span("spfx.plan", 500.0),
             _span("spfx.capture", 1500.0), _span("spfx.solve.capture",
                                                  250.0)]
    steps = {"blocked": {"clock": "device", "assembly_ms": 1.0,
                         "ut_ms": 90.0, "pc_ms": 30.0,
                         "levels": [(60.0, 20.0), (30.0, 10.0)]}}
    return {"counters": {}, "setup": setup, "requests": fac + sol,
            "steps": steps}


def test_readers_arithmetic(monkeypatch):
    snap = _snap()
    monkeypatch.setattr(recorder, "snapshot", lambda: snap)
    refactor = {"mix": {"op": "factorize"}, "completed": 3}
    # the last three factorizations (ids 1-3), less the profiled id 3
    assert _read("entry_permute_ms", refactor) == pytest.approx(11.5)
    assert _read("entry_copy_ms", refactor) == pytest.approx(1.0)
    assert (_read("assembly_ms", refactor), _read("ut_step_ms", refactor),
            _read("pc_step_ms", refactor)) == (1.0, 90.0, 30.0)
    solve = {"mix": {"op": "solve"}, "completed": 2}
    assert _read("solve_graph_ms", solve) == pytest.approx(5.0)
    assert _read("solve_stage_ms", solve) == pytest.approx(4.0)
    assert _read("refine_residual_ms", solve) == pytest.approx(12.0)
    assert _read("refine_sweeps", solve) == pytest.approx(1.0)
    for obs in (refactor, solve):
        assert _read("setup_analyze_s", obs) == pytest.approx(2.0)
        assert _read("setup_plan_s", obs) == pytest.approx(0.5)
        assert _read("setup_capture_s", obs) == pytest.approx(1.75)
    # a cell's request readers read only its own kind of request
    assert _read("entry_permute_ms", solve) is None
    assert _read("refine_sweeps", refactor) is None
    assert _read("entry_copy_ms", dict(refactor, completed=0)) is None


def test_readers_find_nothing_on_host_stamps_or_an_older_program(
        monkeypatch):
    snap = _snap()
    snap["steps"]["blocked"]["clock"] = "host"
    for r in snap["requests"]:
        r["device"] = []
    monkeypatch.setattr(recorder, "snapshot", lambda: snap)
    refactor = {"mix": {"op": "factorize"}, "completed": 3}
    solve = {"mix": {"op": "solve"}, "completed": 2}
    for name in ("assembly_ms", "ut_step_ms", "pc_step_ms"):
        assert _read(name, refactor) is None
    assert _read("solve_graph_ms", solve) is None
    # a program without the recorder's snapshot: every reader reports
    # nothing, and none raises
    monkeypatch.undo()
    from spfx_torch.utils import instrument
    monkeypatch.delattr(instrument, "snapshot")
    assert recorder.snapshot() is None
    for name in NEW:
        for obs in (refactor, solve):
            assert _read(name, obs) is None
