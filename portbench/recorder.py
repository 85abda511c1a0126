"""What the program's own recorder holds (``spfx_torch.utils.instrument``:
its spans, counters, set-up spans and step stamps), as the metric readers
take it after the window, in the run's process.

A program without the recorder (an older checkout) has no ``snapshot``:
every function here then returns None and the readers report nothing.
"""

from __future__ import annotations


def snapshot():
    """The recorder's ``snapshot()``, or None where the program has none."""
    try:
        from spfx_torch.utils import instrument
        read = instrument.snapshot
    except (ImportError, AttributeError):
        return None
    return read()


def requests(obs, op: str):
    """The window's requests of the cell's kind, outside the profiled
    slice: of the records of ``spfx.<op>`` requests, the last
    ``obs["completed"]`` (the window's; the set-up's warm requests came
    before them), less those during which a profiler recorded. None unless
    the mix's requests are ``op``'s and the recorder has some."""
    if obs["mix"]["op"] != op or not obs["completed"]:
        return None
    snap = snapshot()
    if snap is None:
        return None
    reqs = [r for r in snap["requests"] if r["kind"] == "spfx." + op]
    reqs = [r for r in reqs[-obs["completed"]:] if not r["profiled"]]
    return reqs or None


def span_ms(req, name: str) -> float:
    """The total ms of a request's spans named ``name``."""
    return sum(s["ms"] for s in req["spans"] if s["name"] == name)


def spans(req, name: str) -> int:
    """How many of a request's spans are named ``name``."""
    return sum(s["name"] == name for s in req["spans"])


def setup_s(names) -> float | None:
    """The seconds of the process's set-up spans named in ``names`` (the
    cell's own: a run sets up one cell), None where there are none."""
    snap = snapshot()
    if snap is None:
        return None
    ms = [s["ms"] for s in snap["setup"] if s["name"] in names]
    return sum(ms) / 1e3 if ms else None


def steps():
    """The latest replay's step intervals on the device's clock (the panel
    mode replayed last), None where there are none: a CPU walk's are host
    clock reads, which no device metric takes."""
    snap = snapshot()
    if snap is None or not snap["steps"]:
        return None
    last = list(snap["steps"].values())[-1]
    return last if last["clock"] == "device" else None
