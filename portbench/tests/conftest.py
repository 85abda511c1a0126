"""Helpers of the benchmark's tests. Tests that need the card carry the
``card`` marker and skip, deciding inside the test, where there is none:
run them on the card with ``python -m pytest portbench/tests -m card``."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def run_cell(capsys, monkeypatch):
    """Run a cell in this process on the CPU at a small grid, past the
    harness's look for a card; returns (exit code, result line or None).
    The JAX check is the subprocess tests' (a pytest plugin may load JAX
    into this process)."""
    import torch
    from portbench import run
    torch.set_num_threads(2)
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])

    def go(workload, grid=6, seconds=0.5, trace=0, seed=20260101, **kw):
        patch = {"grid": grid, **kw.pop("patch", {})}
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device="cpu", patch=patch, **kw)
        lines = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)
    return go


def card():
    """Skip the calling test unless there is a CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card)")
