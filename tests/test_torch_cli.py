"""The port's CLI (python -m spfx_torch) and its profile scope, on the CPU
(after tests/test_io.py's CLI test)."""

import glob
import json

import pytest

pytest.importorskip("jax")

from spfx import checkpoint as jcheckpoint

import spfx_torch
import spfx_torch.__main__ as cli
from spfx_torch.io import generate, matrix_market
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()


def test_cli_driver(tmp_path, capsys):
    """Both engines, two residual lines, rc 0, and a saved factor that the
    JAX package's load_factor reads and solves with."""
    spd = tmp_path / "spd.mtx"
    matrix_market.write_matrix(str(spd), generate.laplacian_2d(7),
                               symmetric=True)
    uns = tmp_path / "unsym.mtx"
    A = generate.random_unsym(40, 0.1, 1)
    matrix_market.write_matrix(str(uns), A)
    rc = cli.main([str(spd), str(uns), "--device", "cpu", "--save-factor",
                   str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "engine=chol" in out and "engine=lu" in out
    assert out.count("residual") == 2
    assert (tmp_path / "spd.mtx.factor.npz").exists()
    g = jcheckpoint.load_factor(tmp_path / "unsym.mtx.factor.npz")
    b = spfx_torch.synth_rhs(A)
    assert spfx_torch.scaled_residual(A, g.solve(b), b) < 1e-12


def test_cli_gate_and_bad_path(tmp_path, capsys):
    """A missing file fails its read (rc 1); the others still run."""
    spd = tmp_path / "spd.mtx"
    matrix_market.write_matrix(str(spd), generate.laplacian_2d(5),
                               symmetric=True)
    rc = cli.main([str(tmp_path / "missing.mtx"), str(spd), "--device",
                   "cpu"])
    cap = capsys.readouterr()
    assert rc == 1
    assert "read/analyze FAILED" in cap.err
    assert cap.out.count("residual") == 1


def test_profile_scope_writes_trace(tmp_path, monkeypatch, capsys):
    """Config(profile=True) with SPFX_PROFILE_DIR set: a Chrome trace of
    the factorization under <dir>/factorize, and the timing and schedule
    lines on stderr; without the variable, no trace."""
    monkeypatch.setenv("SPFX_PROFILE_DIR", str(tmp_path))
    A = generate.laplacian_3d(4)
    cfg = spfx_torch.Config(dtype="float64", profile=True, validate=True)
    f = spfx_torch.cholesky(A, cfg, device="cpu")
    traces = glob.glob(str(tmp_path / "factorize" / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        assert json.load(fh)["traceEvents"]
    err = capsys.readouterr().err
    assert "factorize" in err and "update_steps=" in err
    assert "solve" in err and f.residual < 1e-12
    monkeypatch.delenv("SPFX_PROFILE_DIR")
    spfx_torch.cholesky(A, cfg, device="cpu")
    assert len(glob.glob(str(tmp_path / "factorize" / "*.json"))) == 1
