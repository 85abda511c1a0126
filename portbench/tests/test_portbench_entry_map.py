"""entry_mapped_share, the share of factorizations whose entry values the
program gathered through its context's map (its counters
``entry_mapped`` and ``entry_fallback``): the reader's arithmetic on a
recorder's snapshot, nothing from a program that counts neither or has no
recorder, and the value in a traced CPU run of each cell that lists it."""

import pytest

from portbench import recorder
from portbench import spec as specs

SPEC = specs.load_spec()
NAME = "entry_mapped_share"
CELLS = [w["name"] for w in SPEC["workloads"]]
REFACTOR = {"mix": {"op": "factorize"}, "completed": 4}


def _read(obs):
    return specs.load_module("metrics", NAME).read(obs)


def _snap(counters):
    """A snapshot whose factorizations counted ``counters`` in turn; the
    first is a warm request before the window, the last one profiled."""
    reqs = [{"id": i, "kind": "spfx.factorize", "profiled": False,
             "counters": dict(c), "device": [], "spans": []}
            for i, c in enumerate(counters)]
    reqs[-1]["profiled"] = True
    return {"counters": {}, "setup": [], "requests": reqs, "steps": {}}


def _with(monkeypatch, snap):
    monkeypatch.setattr(recorder, "snapshot", lambda: snap)


MAPPED = {"entry_mapped": 1, "entry_bytes": 8}
FALLBACK = {"entry_fallback": 1, "entry_bytes": 12}


def test_every_request_mapped(monkeypatch):
    _with(monkeypatch, _snap([FALLBACK] + [MAPPED] * 4))
    assert _read(REFACTOR) == 1.0


@pytest.mark.parametrize("window,share", [
    ([MAPPED, FALLBACK, MAPPED, MAPPED], 2 / 3),
    ([FALLBACK, FALLBACK, MAPPED, MAPPED], 1 / 3),
    ([FALLBACK, FALLBACK, FALLBACK, MAPPED], 0.0)])
def test_a_mix_reads_its_share(monkeypatch, window, share):
    # the warm request is mapped and lies outside the window
    _with(monkeypatch, _snap([MAPPED] + window))
    assert _read(REFACTOR) == pytest.approx(share)


def test_nothing_from_a_program_that_counts_neither(monkeypatch):
    # the parent's requests: entry bytes, no mapped or fallback count
    _with(monkeypatch, _snap([{"entry_bytes": 12}] * 5))
    assert _read(REFACTOR) is None


def test_nothing_without_a_recorder_or_outside_refactor(monkeypatch):
    _with(monkeypatch, _snap([MAPPED] * 5))
    assert _read({"mix": {"op": "solve"}, "completed": 4}) is None
    assert _read(dict(REFACTOR, completed=0)) is None
    _with(monkeypatch, None)
    assert _read(REFACTOR) is None
    monkeypatch.undo()
    from spfx_torch.utils import instrument
    monkeypatch.delattr(instrument, "snapshot")
    assert _read(REFACTOR) is None


def test_listed_for_the_refactor_cells():
    (m,) = [m for m in SPEC["per_layer"] if m["name"] == NAME]
    assert (m["source"], m["layer"], m["moves"]) == (
        "program_counter", "entry", "factorize_ms")
    assert m["workloads"] == [w["name"] for w in SPEC["workloads"]
                              if w["traffic"] == "refactor"]


@pytest.fixture
def fresh():
    from spfx_torch.utils import instrument
    instrument.enable(True)
    instrument.clear()
    yield instrument
    instrument.clear()


@pytest.mark.parametrize("workload", CELLS)
def test_traced_line(run_cell, fresh, workload):
    rc, line = run_cell(workload, trace=1)
    assert rc == 0 and line["correct"] is True
    if workload.endswith(".refactor"):
        assert line["metrics"][NAME]["value"] == 1.0
    else:
        assert NAME not in line["metrics"]
