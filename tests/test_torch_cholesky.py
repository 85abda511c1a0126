"""The port's Cholesky end to end on the CPU (plain PyTorch kernel versions)
against the JAX package: the flat factor, the solve, logdet, L_sparse and
the interop helpers; plus the package's import hygiene."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytest.importorskip("jax")

import spfx

import spfx_torch
from spfx_torch import Config
from spfx_torch.interop import factor_from_numpy
from spfx_torch.io import generate
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spd(n, seed=0):
    """The random SPD matrix of tests/test_mega.py."""
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B @ B.T + sp.diags(np.full(n, n * 0.1)))


MATRICES = {"lap6": lambda: generate.laplacian_3d(6), "spd300": lambda: _spd(300)}
CASES = [(m, d) for m in MATRICES for d in ("float32", "float64")]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{m}-{d}" for m, d in CASES])
def pair(request):
    """(A, dtype, JAX factor, port context, port factor), computed once."""
    name, dtype = request.param
    A = MATRICES[name]()
    jf = spfx.Cholesky(A, spfx.Config(dtype=dtype)).factorize(A)
    ctx = spfx_torch.Cholesky(A, Config(dtype=dtype), device="cpu")
    return A, dtype, jf, ctx, ctx.factorize(A)


def test_flat_factor_matches_jax(pair):
    """f64: rtol 1e-10, atol 1e-12 max|L|. f32: max abs difference
    <= 1e-4 max|L|, because the two sides sum the update products and
    the extend-add in different orders in float32 (measured ~3e-7)."""
    _, dtype, jf, _, f = pair
    Lj = np.asarray(jf.L)
    Lt = f.L.numpy()
    assert Lt.shape == Lj.shape and Lt.dtype == Lj.dtype
    m = np.abs(Lj).max()
    if dtype == "float64":
        np.testing.assert_allclose(Lt, Lj, rtol=1e-10, atol=1e-12 * m)
    else:
        assert np.abs(Lt - Lj).max() <= 1e-4 * m


def test_solve_residual(pair):
    A, _, _, _, f = pair
    b = spfx_torch.synth_rhs(A)
    x = f.solve(b)
    assert spfx_torch.scaled_residual(A, x, b) <= 1e-12
    x2, res = spfx_torch.validate(f)
    assert res <= 1e-12


def test_logdet_matches_jax(pair):
    _, dtype, jf, _, f = pair
    tol = 1e-10 if dtype == "float64" else 1e-5
    assert f.logdet() == pytest.approx(jf.logdet(), rel=tol)


def test_L_sparse_matches_jax(pair):
    _, dtype, jf, _, f = pair
    Lj, Lt = jf.L_sparse(), f.L_sparse()
    np.testing.assert_array_equal(Lt.indptr, Lj.indptr)
    np.testing.assert_array_equal(Lt.indices, Lj.indices)
    d = abs(Lt - Lj).max()
    tol = 1e-10 if dtype == "float64" else 1e-4
    assert d <= tol * abs(Lj).max()


def test_interop_factor_solves_same_x(pair):
    """The JAX factor, carried into the port, solves to the JAX solution."""
    A, _, jf, ctx, _ = pair
    b = spfx_torch.synth_rhs(A)
    f = factor_from_numpy(ctx, np.asarray(jf.L), "cpu")
    np.testing.assert_allclose(f.solve(b), jf.solve(b), rtol=1e-12,
                               atol=1e-14)


def test_interop_rejects_wrong_size(pair):
    _, _, _, ctx, _ = pair
    with pytest.raises(ValueError, match="plan stores"):
        factor_from_numpy(ctx, np.zeros(ctx.plan.storage + 1), "cpu")


def test_refactorize_same_context(pair):
    A, _, _, ctx, f = pair
    f2 = ctx.factorize(A)
    assert torch.equal(f2.L, f.L)
    assert ctx.factorize_time > 0 and ctx.analyze_time > 0 \
        and ctx.plan_time > 0


def test_engines_calls_and_mega_agree():
    A = generate.laplacian_3d(5)
    a = spfx_torch.cholesky(A, Config(dtype="float64", engine="calls"),
                            device="cpu")
    b = spfx_torch.cholesky(A, Config(dtype="float64", engine="mega"),
                            device="cpu")
    assert torch.equal(a.L, b.L)


def test_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spfx_torch.cholesky(generate.laplacian_3d(3))


def test_update_precision_restores_torch_state():
    """A separate update precision switches torch's float32 matmul mode
    only around the updates, and the walk leaves the global mode as it
    found it; float64 products are unaffected, so the factor is the same."""
    A = generate.laplacian_3d(4)
    before = (torch.get_float32_matmul_precision(),
              torch.backends.cuda.matmul.allow_tf32)
    a = spfx_torch.cholesky(A, Config(dtype="float64"), device="cpu")
    b = spfx_torch.cholesky(A, Config(dtype="float64",
                                      update_precision="default"),
                            device="cpu")
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32) == before
    assert torch.equal(a.L, b.L)


def test_import_leaves_no_jax():
    code = ("import sys, spfx_torch, spfx_torch.interop, "
            "spfx_torch.lu.factorize, spfx_torch.lu.pivot, "
            "spfx_torch.kernels.route, spfx_torch.kernels.panel_lanes, "
            "spfx_torch.kernels.panel_wide, spfx_torch.kernels.extend_add, "
            "spfx_torch.kernels.syrk_gemm, spfx_torch.kernels.chol_small, "
            "spfx_torch.bench.panels, spfx_torch.kernels.mega, "
            "spfx_torch.checkpoint, spfx_torch.__main__, "
            "spfx_torch.utils.instrument\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'spfx')]\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == ""


def _port_sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "spfx_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_import_no_jax():
    """AST scan: no ``import jax``/``from jax`` and no import of ``spfx``
    anywhere in spfx_torch/ or chip_smoke.py."""
    srcs = list(_port_sources())
    assert len(srcs) > 10
    for f in ("lu/factorize.py", "lu/pivot.py", "kernels/route.py",
              "kernels/panel_lanes.py", "kernels/panel_wide.py",
              "kernels/extend_add.py", "kernels/syrk_gemm.py",
              "kernels/chol_small.py", "bench/panels.py",
              "kernels/mega.py", "checkpoint.py", "__main__.py",
              "utils/instrument.py"):
        assert os.path.join(ROOT, "spfx_torch", f) in srcs
    for path in srcs:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "spfx"), \
                    f"{path} imports {n}"
