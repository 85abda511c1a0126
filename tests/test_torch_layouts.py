"""The non-default bucket kinds and engines of the real-valued factorization
against the JAX package: UC buckets (``Config(update_tile=0)``), the rowwin
layout (``Config(layout="rowwin")``) and the fused engine, for Cholesky and
LU, f32 and f64.

Plans table by table; whole factorizations under every engine; the rowwin
level solves bucket by bucket and the device solve; the fused engine's
chunks; checkpoints; and the window checks of each bucket kind (every step
of these plans is in test_torch_layout_steps.py).
Tolerances are those of the UT-step tests: 1e-12 (f64) and 1e-5 (f32) of
the array's largest entry."""

import copy

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytest.importorskip("jax")
import jax.numpy as jnp

import spfx
from spfx import checkpoint as jcheckpoint
from spfx.kernels import blocks as jblocks
from spfx.kernels import fused as jfused

import spfx_torch
from spfx_torch import Config, checkpoint
from spfx_torch.chol.factorize import check_windows
from spfx_torch.interop import (factor_from_numpy, lu_factor_from_numpy,
                                plan_arrays)
from spfx_torch.io import generate
from spfx_torch.kernels import blocks, fused, mega
from spfx_torch.plan.schedule import (PanelBucket, PanelBucketC,
                                      UpdateBucket, UpdateBucketC)
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

DTYPES = ("float32", "float64")
TOL = {"float32": 1e-5, "float64": 1e-12}
LAYOUTS = {"uc": dict(update_tile=0), "rowwin": dict(layout="rowwin")}


def _spd(n, seed=0):
    """The random SPD matrix of tests/test_mega.py."""
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B @ B.T + sp.diags(np.full(n, n * 0.1)))


def _unsym(n, seed=1):
    """The random unsymmetric matrix of tests/test_mega.py."""
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B + sp.diags(np.abs(B).sum(axis=1).A1 + 1.0))


# (matrix, kind): the Laplacian for both kinds, the n = 300 SPD matrix for
# Cholesky, the n = 300 unsymmetric one for LU
CASES = [("lap6", False), ("spd300", False), ("lap6", True),
         ("unsym300", True)]
CASE_IDS = [f"{m}-{'lu' if lu else 'chol'}" for m, lu in CASES]
MATRICES = {"lap6": lambda: generate.laplacian_3d(6),
            "spd300": lambda: _spd(300), "unsym300": lambda: _unsym(300)}


def _contexts(name, lu, dtype, **kw):
    """(A, the JAX context, the port's CPU context) under one Config."""
    A = MATRICES[name]()
    jk = spfx.LU if lu else spfx.Cholesky
    tk = spfx_torch.LU if lu else spfx_torch.Cholesky
    return (A, jk(A, spfx.Config(dtype=dtype, **kw)),
            tk(A, Config(dtype=dtype, **kw), device="cpu"))


def _names(lu):
    return ("Lx", "Ux") if lu else ("L",)


def _close(got, ref, dtype, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=TOL[dtype] * np.abs(ref).max(),
                               err_msg=what)


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,lu", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plans_identical(layout, name, lu):
    """The same tables in both packages, of the kinds the layout makes,
    and the port's window checks pass."""
    _, jctx, tctx = _contexts(name, lu, "float64", **LAYOUTS[layout])
    ja, ta = plan_arrays(jctx.plan), plan_arrays(tctx.plan)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    ups = [ub for lp in tctx.plan.levels for ub in lp.updates]
    pbs = [pb for lp in tctx.plan.levels for pb in lp.panels]
    assert ups and pbs
    if layout == "uc":
        assert all(type(ub) is UpdateBucketC and ub.head_start is None
                   for ub in ups)
        assert all(type(pb) is PanelBucketC for pb in pbs)
    else:
        assert all(type(ub) is UpdateBucket for ub in ups)
        assert all(type(pb) is PanelBucket for pb in pbs)
    check_windows(tctx.plan)


# --------------------------------------------------------------------------
# whole factorizations
# --------------------------------------------------------------------------

ENGINES = [("uc", "mega"), ("uc", "calls"), ("rowwin", "mega"),
           ("rowwin", "calls"), ("rowwin", "fused")]
FACT_CASES = [(lay, eng, lu, d) for lay, eng in ENGINES
              for lu in (False, True) for d in DTYPES]
_JAX_REF = {}


def _jax_reference(layout, lu, dtype):
    """(A, JAX flat factors) of the Laplacian (Cholesky) or the n = 300
    unsymmetric matrix (LU) under ``layout``, by JAX's per-call engine;
    one per (layout, kind, dtype) for every port engine."""
    key = layout, lu, dtype
    if key not in _JAX_REF:
        A, jctx, _ = _contexts("unsym300" if lu else "lap6", lu, dtype,
                               **LAYOUTS[layout], engine="calls")
        jf = jctx.factorize(A)
        _JAX_REF[key] = A, [np.asarray(getattr(jf, k)) for k in _names(lu)]
    return _JAX_REF[key]


@pytest.mark.parametrize(
    "layout,engine,lu,dtype", FACT_CASES,
    ids=[f"{la}-{e}-{'lu' if lu else 'chol'}-{d}"
         for la, e, lu, d in FACT_CASES])
def test_factorization_matches_jax(layout, engine, lu, dtype):
    A, ref = _jax_reference(layout, lu, dtype)
    kind = spfx_torch.LU if lu else spfx_torch.Cholesky
    ctx = kind(A, Config(dtype=dtype, engine=engine, **LAYOUTS[layout]),
               device="cpu")
    f = ctx.factorize(A)
    for k, want in zip(_names(lu), ref):
        _close(getattr(f, k).numpy(), want, dtype, k)
    b = spfx_torch.synth_rhs(A)
    assert spfx_torch.scaled_residual(A, f.solve(b), b) <= 1e-12
    if engine == "fused":
        assert isinstance(ctx._runner, fused.FusedRunner)
        assert isinstance(ctx._solver, fused.FusedSolver)


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_fused_alias_and_device_solve(lu):
    """``fused=True`` is ``engine="fused"``; the fused device solve
    equals the mega one and refines to the residual limit."""
    A, ref = _jax_reference("rowwin", lu, "float64")
    kind = spfx_torch.LU if lu else spfx_torch.Cholesky
    ctx = kind(A, Config(dtype="float64", layout="rowwin", fused=True,
                         solve_backend="device"), device="cpu")
    f = ctx.factorize(A)
    assert isinstance(ctx._runner, fused.FusedRunner)
    for k, want in zip(_names(lu), ref):
        _close(getattr(f, k).numpy(), want, "float64", k)
    b = spfx_torch.synth_rhs(A)
    x_fused = f.solve(b, refine=0)
    f._solver = mega.MegaSolver(f.plan, lu=lu, config=f.config,
                                device="cpu")
    np.testing.assert_allclose(f.solve(b, refine=0), x_fused, rtol=0,
                               atol=1e-12 * np.abs(x_fused).max())
    assert spfx_torch.scaled_residual(A, f.solve(b), b) <= 1e-12


# --------------------------------------------------------------------------
# the rowwin level solves and the device solve
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,lu", CASES, ids=CASE_IDS)
def test_rowwin_level_solves_match_jax(name, lu):
    """solve_fwd_level at every P bucket in level order, then
    solve_bwd_level in reverse (LU: JAX's solve_*_level_lu), each on the
    same x (n + 1, 2) as JAX's, in f64 and f32, on the JAX factor. Each
    output within TOL of max|x|; the port's is in place on x."""
    A, jctx, tctx = _contexts(name, lu, "float64", layout="rowwin",
                              engine="calls")
    jf = jctx.factorize(A)
    F64 = (np.asarray(jf.Lx), np.asarray(jf.Ux)) if lu \
        else (np.asarray(jf.L),) * 2
    jpbs = [pb for lp in jf.plan.levels for pb in lp.panels]
    tpbs = [pb for lp in tctx.plan.levels for pb in lp.panels]
    assert len(jpbs) == len(tpbs) > 1
    jfwd = jblocks.solve_fwd_level_lu if lu else jblocks.solve_fwd_level
    jbwd = jblocks.solve_bwd_level_lu if lu else jblocks.solve_bwd_level
    n = A.shape[0]
    for dtype in DTYPES:
        F = [f.astype(dtype) for f in F64]
        x = np.zeros((n + 1, 2), dtype)
        x[:n] = np.random.default_rng(0).standard_normal((n, 2))
        for jfn, tfn, Fk, pairs in (
                (jfwd, blocks.solve_fwd_level, F[0], list(zip(jpbs, tpbs))),
                (jbwd, blocks.solve_bwd_level, F[1],
                 list(zip(jpbs, tpbs))[::-1])):
            for jp, tp in pairs:
                xj = np.asarray(jfn(jnp.asarray(Fk), jnp.asarray(x),
                                    *jp.dev()))
                xt = torch.from_numpy(x.copy())
                assert tfn(torch.from_numpy(Fk), xt, *tp.to("cpu"),
                           lu=lu) is xt
                _close(xt.numpy()[:n], xj[:n], dtype)
                x = xj


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_rowwin_device_solve_matches_jax(lu):
    """One unrefined device solve pass under rowwin, on the JAX factor
    carried over, against JAX's MegaSolver (f64)."""
    A, jctx, tctx = _contexts("unsym300" if lu else "spd300", lu, "float64",
                              layout="rowwin", engine="mega",
                              solve_backend="device")
    jf = jctx.factorize(A)
    tf = lu_factor_from_numpy(tctx, np.asarray(jf.Lx), np.asarray(jf.Ux),
                              "cpu") if lu \
        else factor_from_numpy(tctx, np.asarray(jf.L), "cpu")
    b = spfx_torch.synth_rhs(A)
    xj = np.asarray(jf.solve(b, refine=0))
    xt = tf.solve(b, refine=0)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12 * np.abs(xj).max())
    assert spfx_torch.scaled_residual(A, tf.solve(b), b) <= 1e-12


# --------------------------------------------------------------------------
# the fused engine's chunks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("calls", [24, 5, 1])
@pytest.mark.parametrize("name,lu", CASES[:2] + CASES[3:], ids=[
    i for i in CASE_IDS if i != "lap6-lu"])
def test_chunk_levels_match_jax(name, lu, calls):
    """The same chunks, level for level, over the rowwin plan and over its
    reversed levels (the backward solve's)."""
    _, jctx, tctx = _contexts(name, lu, "float64", layout="rowwin")
    for jlev, tlev in ((jctx.plan.levels, tctx.plan.levels),
                       (jctx.plan.levels[::-1], tctx.plan.levels[::-1])):
        jpos = {id(lp): i for i, lp in enumerate(jlev)}
        tpos = {id(lp): i for i, lp in enumerate(tlev)}
        jc = [[jpos[id(lp)] for lp in c]
              for c in jfused.chunk_levels(jlev, calls)]
        tc = [[tpos[id(lp)] for lp in c]
              for c in fused.chunk_levels(tlev, calls)]
        assert tc == jc and (calls == 24 or len(tc) > 1)
    assert fused.CALLS_PER_CHUNK == jfused.CALLS_PER_CHUNK


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_fused_refuses_contig_plans(lu):
    A = generate.laplacian_3d(4)
    kind = spfx_torch.LU if lu else spfx_torch.Cholesky
    ctx = kind(A, Config(engine="fused"), device="cpu")
    for cls in (fused.FusedRunner, fused.FusedSolver):
        with pytest.raises(ValueError, match="rowwin"):
            cls(ctx.plan, lu=lu, device="cpu")
    with pytest.raises(ValueError, match="rowwin"):
        ctx.factorize(A)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["torch-to-torch", "jax-to-torch",
                                       "torch-to-jax"])
@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_rowwin_checkpoint_roundtrip(tmp_path, lu, direction):
    """A rowwin factor saved and loaded under its own config is the same
    factor and solves alike; under a contig config it is refused."""
    A = _unsym(120, seed=5) if lu else generate.laplacian_3d(5)
    kw = dict(dtype="float64", layout="rowwin")
    if direction.startswith("jax"):
        f = (spfx.lu if lu else spfx.cholesky)(A, spfx.Config(**kw))
        save = jcheckpoint.save_factor
    else:
        f = (spfx_torch.lu if lu else spfx_torch.cholesky)(A, Config(**kw),
                                                           device="cpu")
        save = checkpoint.save_factor
    p = tmp_path / "f.npz"
    save(p, f)
    if direction.endswith("jax"):
        g = jcheckpoint.load_factor(p, config=spfx.Config(**kw))
    else:
        g = checkpoint.load_factor(p, config=Config(**kw), device="cpu")
        with pytest.raises(ValueError, match="layout"):
            checkpoint.load_factor(p, config=Config(dtype="float64"),
                                   device="cpu")
    for k in _names(lu):
        a, b = (np.asarray(t.numpy() if torch.is_tensor(t) else t)
                for t in (getattr(f, k), getattr(g, k)))
        assert a.dtype == b.dtype and np.array_equal(a, b)
    b = spfx_torch.synth_rhs(A)
    np.testing.assert_allclose(g.solve(b, refine=0), f.solve(b, refine=0),
                               rtol=0, atol=1e-12)
    assert spfx_torch.scaled_residual(A, g.solve(b), b) <= 1e-12


# --------------------------------------------------------------------------
# the window checks of each bucket kind
# --------------------------------------------------------------------------

def _first(plan, pred):
    return next(b for lp in plan.levels
                for b in list(lp.updates) + list(lp.panels) if pred(b))


def _uc_window(plan):
    ub = _first(plan, lambda b: isinstance(b, UpdateBucketC))
    ub.src_start[0] = plan.storage - 1


def _uc_row(plan):
    ub = _first(plan, lambda b: isinstance(b, UpdateBucketC))
    ub.tgt_lrow[0, 0] = ub.slab_rows


def _uc_table(plan):
    ub = _first(plan, lambda b: isinstance(b, UpdateBucketC))
    ub.tgt_lrow = np.concatenate([ub.tgt_lrow, ub.tgt_lrow], axis=1)


def _u_source(plan):
    ub = _first(plan, lambda b: isinstance(b, UpdateBucket))
    ub.src_row_start[0, 0] = plan.storage - 1


def _u_target(plan):
    ub = _first(plan, lambda b: isinstance(b, UpdateBucket))
    ub.tgt_row_start[0, 0] = plan.storage - 1


def _u_column(plan):
    ub = _first(plan, lambda b: isinstance(b, UpdateBucket))
    ub.tgt_cpos[0, 0] = ub.csp


def _p_below(plan):
    pb = _first(plan, lambda b: isinstance(b, PanelBucket)
                and b.below_row_start.shape[1])
    pb.below_row_start[0, 0] = plan.storage - 1


def _pc_block(plan):
    pb = _first(plan, lambda b: isinstance(b, PanelBucketC))
    pb.slab_lo[0] = plan.storage - 1


FAULTS = [("uc", _uc_window, "source window past the end"),
          ("uc", _uc_row, "row past its slab"),
          ("uc", _uc_table, "row table"),
          ("uc", _pc_block, "panel block past the end"),
          ("rowwin", _u_source, "source row window past the end"),
          ("rowwin", _u_target, "target row window past the end"),
          ("rowwin", _u_column, "column past its target width"),
          ("rowwin", _p_below, "below row window past the end")]


@pytest.mark.parametrize("layout,fault,match", FAULTS,
                         ids=[f[1].__name__[1:] for f in FAULTS])
def test_check_windows_catches_each_kind(layout, fault, match):
    ctx = spfx_torch.Cholesky(_spd(300), Config(**LAYOUTS[layout]),
                              device="cpu")
    plan = copy.deepcopy(ctx.plan)
    check_windows(plan)
    fault(plan)
    with pytest.raises(ValueError, match=match):
        check_windows(plan)
