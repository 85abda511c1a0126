"""The port's executor and device solve (spfx_torch.kernels.mega) on the CPU
against the JAX package: the contig level solves at every PC bucket of a
plan, on a JAX factor carried over with spfx_torch.interop; the unrefined
device solve against JAX's mega device solve on the same factor; the
refined residual; the runner's entry points (mega against calls,
run_repeat, trace_fn); and the options that stay unported."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

import spfx
from spfx.kernels import blocks as jblocks

import spfx_torch
from spfx_torch import Config
from spfx_torch.interop import factor_from_numpy, lu_factor_from_numpy
from spfx_torch.io import generate
from spfx_torch.kernels import blocks
from spfx_torch.kernels.mega import MegaRunner, MegaSolver
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

DTYPES = ("float32", "float64")
# relative to max|x|: f64 the two sides' sums in other orders; f32 the
# same at float32's epsilon
TOL = {"float32": 1e-5, "float64": 1e-12}


def _spd(n, seed=0):
    """The random SPD matrix of tests/test_mega.py."""
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B @ B.T + sp.diags(np.full(n, n * 0.1)))


def _unsym(n, seed=1):
    """The random unsymmetric matrix of tests/test_mega.py."""
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B + sp.diags(np.abs(B).sum(axis=1).A1 + 1.0))


def _context(A, lu, dtype, **kw):
    kind = spfx_torch.LU if lu else spfx_torch.Cholesky
    return kind(A, Config(dtype=dtype, **kw), device="cpu")


def _jax_factor(A, lu, dtype, **kw):
    kind = spfx.LU if lu else spfx.Cholesky
    return kind(A, spfx.Config(dtype=dtype, **kw)).factorize(A)


def _carry(ctx, jf):
    """The port factor of ``ctx`` holding the JAX factor's values."""
    if hasattr(jf, "Ux"):
        return lu_factor_from_numpy(ctx, np.asarray(jf.Lx),
                                    np.asarray(jf.Ux), "cpu")
    return factor_from_numpy(ctx, np.asarray(jf.L), "cpu")


# --------------------------------------------------------------------------
# the level solves, bucket by bucket
# --------------------------------------------------------------------------

LEVEL_CASES = [(m, lu) for m in ("lap6", "spd300") for lu in (False, True)]


@pytest.mark.parametrize("name,lu", LEVEL_CASES,
                         ids=[f"{m}-{'lu' if lu else 'chol'}"
                              for m, lu in LEVEL_CASES])
def test_level_solves_match_jax(name, lu):
    """solve_fwd_level_c at every PC bucket in level order, then
    solve_bwd_level_c in reverse (LU: unit L forward on Lx, U backward
    from Ux), each on the same x (n + 1, 2) as JAX's, in f64 and in f32,
    on the JAX factor (f64, cast for f32; its per-call engine, which
    compiles faster than the mega one). Each output within TOL of
    max|x|; the port's is in place on x."""
    A = generate.laplacian_3d(6) if name == "lap6" else _spd(300)
    jf = _jax_factor(A, lu, "float64", engine="calls")
    F64 = (np.asarray(jf.Lx), np.asarray(jf.Ux)) if lu \
        else (np.asarray(jf.L),) * 2
    jpbs = [pb for lp in jf.plan.levels for pb in lp.panels]
    tpbs = [pb for lp in _context(A, lu, "float64").plan.levels
            for pb in lp.panels]
    assert len(jpbs) == len(tpbs) > 1
    n = A.shape[0]
    for dtype in DTYPES:
        F = [f.astype(dtype) for f in F64]
        x = np.zeros((n + 1, 2), dtype)
        x[:n] = np.random.default_rng(0).standard_normal((n, 2))
        sweeps = ((jblocks.solve_fwd_level_c, blocks.solve_fwd_level_c,
                   F[0], list(zip(jpbs, tpbs))),
                  (jblocks.solve_bwd_level_c, blocks.solve_bwd_level_c,
                   F[1], list(zip(jpbs, tpbs))[::-1]))
        for jfn, tfn, Fk, pairs in sweeps:
            for jp, tp in pairs:
                assert (jp.cp, jp.rbp) == (tp.cp, tp.rbp)
                xj = np.asarray(jfn(jnp.asarray(Fk), jnp.asarray(x),
                                    *jp.dev(), cp=jp.cp, rbp=jp.rbp, lu=lu))
                xt = torch.from_numpy(x.copy())
                out = tfn(torch.from_numpy(Fk), xt, *tp.to("cpu"),
                          cp=tp.cp, rbp=tp.rbp, lu=lu)
                assert out is xt
                scale = np.abs(xj[:n]).max()
                np.testing.assert_allclose(xt.numpy()[:n], xj[:n], rtol=0,
                                           atol=TOL[dtype] * scale)
                x = xj


# --------------------------------------------------------------------------
# the whole device solve
# --------------------------------------------------------------------------

SOLVE_CASES = [(lu, d) for lu in (False, True) for d in DTYPES]


@pytest.fixture(scope="module", params=SOLVE_CASES,
                ids=[f"{'lu' if lu else 'chol'}-{d}" for lu, d in SOLVE_CASES])
def carried(request):
    """(A, JAX mega device-solve factor, port factor with its values),
    at the matrices of tests/test_mega.py's device-solve tests."""
    lu, dtype = request.param
    A = _unsym(400, seed=4) if lu else _spd(400, seed=3)
    jf = _jax_factor(A, lu, dtype, engine="mega", solve_backend="device")
    ctx = _context(A, lu, dtype, solve_backend="device")
    return A, dtype, jf, _carry(ctx, jf)


def test_device_solve_matches_jax(carried):
    """One unrefined forward + backward pass, within TOL of max|x|."""
    A, dtype, jf, tf = carried
    assert not tf._use_host_solve()
    b = spfx_torch.synth_rhs(A)
    xj = jf.solve(b, refine=0)
    xt = tf.solve(b, refine=0)
    np.testing.assert_allclose(xt, xj, rtol=0,
                               atol=TOL[dtype] * np.abs(xj).max())
    B = np.stack([b, 2.0 * b + 1.0], axis=1)       # two right-hand sides
    np.testing.assert_allclose(tf.solve(B, refine=0)[:, 0], xt, rtol=0,
                               atol=TOL[dtype] * np.abs(xj).max())


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_device_solve_refined_residual(lu):
    """The port's own f64 factorization and device solve, refined."""
    A = _unsym(400, seed=4) if lu else _spd(400, seed=3)
    ctx = _context(A, lu, "float64", solve_backend="device")
    f = ctx.factorize(A)
    assert f._solver is ctx._solver is not None
    b = spfx_torch.synth_rhs(A)
    assert spfx_torch.scaled_residual(A, f.solve(b), b) < 1e-12


def test_static_pivot_device_solve():
    """LU with the static pivot: the device solve permutes b's rows on
    the way in, as the host solve does."""
    A = generate.random_unsym(60, density=0.1, seed=12)
    A = sp.csc_matrix(A[np.random.default_rng(1).permutation(60)])
    f = spfx_torch.lu(A, Config(dtype="float64", static_pivot=True,
                                solve_backend="device"), device="cpu")
    assert f.row_perm is not None
    b = spfx_torch.synth_rhs(A)
    assert spfx_torch.scaled_residual(A, f.solve(b), b) < 1e-12
    np.testing.assert_allclose(f._solve_device(b), f._solve_host(b),
                               rtol=0, atol=1e-10 * np.abs(b).max())


# --------------------------------------------------------------------------
# the runner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["spd300", "lap7"])
def test_mega_chol_matches_calls(name):
    A = _spd(300) if name == "spd300" else generate.laplacian_3d(7)
    fc = _context(A, False, "float64", engine="calls").factorize(A)
    fm = _context(A, False, "float64", engine="mega").factorize(A)
    np.testing.assert_allclose(fm.L.numpy(), fc.L.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_mega_lu_matches_calls():
    A = _unsym(300)
    fc = _context(A, True, "float64", engine="calls").factorize(A)
    fm = _context(A, True, "float64", engine="mega").factorize(A)
    np.testing.assert_allclose(fm.Lx.numpy(), fc.Lx.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(fm.Ux.numpy(), fc.Ux.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_run_repeat_and_trace_fn_match_run(lu):
    """run_repeat(3) and the eager trace_fn give run's factor; each call
    returns its own tensor."""
    A = generate.laplacian_3d(5)
    ctx = _context(A, lu, "float64")
    vals = ctx.entry_values(A)
    vals = vals if lu else (vals,)
    r = MegaRunner(ctx.plan, lu=lu, config=ctx.config, device="cpu")
    ref = r.run(*vals)
    for got in (r.run_repeat(3, *vals), r.trace_fn()(*vals), r.run(*vals)):
        for g, e in zip(got if lu else (got,), ref if lu else (ref,)):
            assert g is not e and torch.equal(g, e)
    with pytest.raises(ValueError, match="reps"):
        r.run_repeat(0, *vals)
    assert r.replays == 0 and r.captures == {}     # nothing captured on CPU


def test_solver_forward_backward_is_solve():
    """MegaSolver.solve = backward(forward(x)), in place on the CPU."""
    A = generate.laplacian_3d(5)
    f = spfx_torch.cholesky(A, Config(dtype="float64"), device="cpu")
    s = MegaSolver(f.plan, lu=False, config=f.config, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (A.shape[0] + 1, 3)))
    x[-1] = 0
    want = s.backward(f.L, s.forward(f.L, x.clone()))
    assert s.solve(f.L, f.L, x, {}) is x and torch.equal(x, want)


def test_solve_backend_values():
    """'device' no longer raises; an unknown backend does."""
    A = generate.laplacian_3d(3)
    spfx_torch.Cholesky(A, Config(solve_backend="device"), device="cpu")
    with pytest.raises(ValueError, match="solve_backend"):
        spfx_torch.Cholesky(A, Config(solve_backend="gpu"), device="cpu")
