"""``factor_tflops``: the plan's operations from the cell's ``spfx.plan``
set-up span over the latest replay's step intervals. Its arithmetic on a
recorder's snapshot, nothing where there is nothing to read (no recorder,
a program whose plan span carries no ``flops``, steps on the host's clock,
a solve mix), the cells it lists, and the float64 cell's traced run on
the CPU: the program's plan span carries the arithmetic, and the reader
finds no device clock there."""

import pytest

from portbench import recorder
from portbench import spec as specs
from portbench.tests.test_portbench_trace import _snap, _span

SPEC = specs.load_spec()
REFACTOR = {"mix": {"op": "factorize"}, "completed": 3}
SOLVE = {"mix": {"op": "solve"}, "completed": 2}


def _read(obs):
    return specs.load_module("metrics", "factor_tflops").read(obs)


def _with_plan(attrs):
    """_snap() whose plan span carries ``attrs``; a second context's plan
    span (an earlier one, without them) comes first."""
    snap = _snap()
    snap["setup"] = [_span("spfx.plan", 300.0, sid=9)] + [
        dict(s, attrs=attrs) if s["name"] == "spfx.plan" else s
        for s in snap["setup"]]
    return snap


def test_value(monkeypatch):
    snap = _with_plan({"dtype": "float64", "flops": 40.4e9})
    monkeypatch.setattr(recorder, "snapshot", lambda: snap)
    # 40.4 GFLOP over assembly 1 + UT 90 + PC 30 ms
    assert _read(REFACTOR) == pytest.approx(40.4e9 / 121e-3 / 1e12)


@pytest.mark.parametrize("case", ["no recorder", "no flops", "host clock",
                                  "solve mix", "no steps"])
def test_nothing_to_read(monkeypatch, case):
    snap = _with_plan({"flops": 40.4e9})
    obs = REFACTOR
    if case == "no recorder":
        snap = None
    elif case == "no flops":
        snap = _snap()          # an older program's plan span
    elif case == "host clock":
        snap["steps"]["blocked"]["clock"] = "host"
    elif case == "solve mix":
        obs = SOLVE
    else:
        snap["steps"] = {}
    monkeypatch.setattr(recorder, "snapshot", lambda: snap)
    assert _read(obs) is None


def test_lists_the_refactor_cells():
    (m,) = [m for m in SPEC["per_layer"] if m["name"] == "factor_tflops"]
    assert m["workloads"] == [w["name"] for w in SPEC["workloads"]
                              if w["traffic"] == "refactor"]
    assert len(m["workloads"]) == 3
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "TFLOP/s", "higher", "program_span", "steps", "factorize_ms")


def test_float64_cell_traced_on_the_cpu(run_cell):
    from spfx_torch.utils import instrument
    instrument.enable(True)
    instrument.clear()
    rc, line = run_cell("poisson3d-48-chol-f64.refactor", trace=1)
    assert rc == 0 and line["correct"] is True
    assert "factor_tflops" not in line["metrics"]    # host-clock steps
    snap = instrument.snapshot()
    (plan,) = [s for s in snap["setup"] if s["name"] == "spfx.plan"]
    assert plan["attrs"]["dtype"] == "float64"
    assert plan["attrs"]["itemsize"] == 8 and plan["attrs"]["flops"] > 0
    assert {r["spans"][-1]["attrs"]["dtype"] for r in snap["requests"]
            if r["kind"] == "spfx.factorize"} == {"float64"}
    instrument.clear()
