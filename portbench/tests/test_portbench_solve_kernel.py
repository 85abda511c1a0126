"""solve_kernel_share, the share of the device solve's bucket steps that
took the level-solve kernel (the program's counters ``solve_kernel_steps``
and ``solve_chain_steps``): the reader's arithmetic on a recorder's
snapshot, and nothing from a program that counts neither or has no
recorder."""

import pytest

from portbench import recorder
from portbench import spec as specs

SPEC = specs.load_spec()
NAME = "solve_kernel_share"
SOLVE = {"mix": {"op": "solve"}, "completed": 4}


def _read(obs):
    return specs.load_module("metrics", NAME).read(obs)


def _snap(counters):
    """A snapshot whose solve requests counted ``counters`` in turn; the
    first is a warm request before the window, the last one profiled."""
    reqs = [{"id": i, "kind": "spfx.solve", "profiled": False,
             "counters": dict(c, solve_passes=2), "device": [], "spans": []}
            for i, c in enumerate(counters)]
    reqs[-1]["profiled"] = True
    return {"counters": {}, "setup": [], "requests": reqs, "steps": {}}


def _with(monkeypatch, snap):
    monkeypatch.setattr(recorder, "snapshot", lambda: snap)


KERNEL = {"solve_kernel_steps": 1580, "solve_chain_steps": 0}
CHAIN = {"solve_kernel_steps": 0, "solve_chain_steps": 1580}
MIXED = {"solve_kernel_steps": 1500, "solve_chain_steps": 500}


def test_every_step_through_the_kernel(monkeypatch):
    _with(monkeypatch, _snap([CHAIN] + [KERNEL] * 3 + [CHAIN]))
    assert _read(SOLVE) == 1.0


@pytest.mark.parametrize("window,share", [
    ([KERNEL, MIXED, CHAIN], (1580 + 1500) / (2 * 1580 + 2000)),
    ([MIXED, MIXED, KERNEL], (1500 + 1500 + 1580) / (2 * 2000 + 1580)),
    ([CHAIN, CHAIN, MIXED], 1500 / (2 * 1580 + 2000))])
def test_both_counters_read_their_share(monkeypatch, window, share):
    # the warm request before the window and the profiled one at its end
    # are not read
    _with(monkeypatch, _snap([KERNEL] + window + [KERNEL]))
    assert _read(SOLVE) == pytest.approx(share)


def test_only_the_chain_reads_zero(monkeypatch):
    # the CPU, a complex factor or rowwin buckets: every step on the chain
    _with(monkeypatch, _snap([{"solve_chain_steps": 1580}] * 5))
    assert _read(SOLVE) == 0.0


def test_nothing_from_a_program_that_counts_neither(monkeypatch):
    # the parent's requests: passes, no step counters
    _with(monkeypatch, _snap([{}] * 5))
    assert _read(SOLVE) is None


def test_nothing_without_a_recorder_or_outside_solve(monkeypatch):
    _with(monkeypatch, _snap([KERNEL] * 5))
    assert _read({"mix": {"op": "factorize"}, "completed": 3}) is None
    assert _read(dict(SOLVE, completed=0)) is None
    _with(monkeypatch, None)
    assert _read(SOLVE) is None
    monkeypatch.undo()
    from spfx_torch.utils import instrument
    monkeypatch.delattr(instrument, "snapshot")
    assert _read(SOLVE) is None


def test_listed_for_the_solve_cells():
    (m,) = [m for m in SPEC["per_layer"] if m["name"] == NAME]
    assert (m["source"], m["layer"], m["moves"], m["unit"]) == (
        "program_counter", "executor", "solve_ms", "share")
    assert m["workloads"] == [w["name"] for w in SPEC["workloads"]
                              if w["traffic"] == "solve16"]
    assert SPEC["per_layer"][-1] is m


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]
                                      if w["traffic"] == "solve16"])
def test_traced_cpu_line_reads_the_chain(run_cell, workload):
    """On the CPU every bucket step takes the chain: a traced run's line
    carries the share at 0; an untraced one carries none."""
    from spfx_torch.utils import instrument
    instrument.enable(True)
    instrument.clear()
    try:
        rc, line = run_cell(workload, trace=1)
        assert rc == 0 and line["correct"] is True
        assert line["metrics"][NAME]["value"] == 0.0
        rc, line = run_cell(workload, trace=0)
        assert rc == 0 and NAME not in line["metrics"]
    finally:
        instrument.clear()
