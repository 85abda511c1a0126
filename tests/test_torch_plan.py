"""The port's host layers are copies of the JAX package's: the same matrix
and Config give the same symbolic analysis and the same plan, array for
array, so both packages factor into the same flat storage layout."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytest.importorskip("jax")

from spfx.io import generate as jgen
from spfx.plan.schedule import build_plan as jbuild_plan
from spfx.symbolic.analyze import analyze as janalyze
from spfx.utils.config import Config as JConfig

from spfx_torch.chol.factorize import check_windows
from spfx_torch.interop import plan_arrays
from spfx_torch.io import generate
from spfx_torch.plan.schedule import build_plan
from spfx_torch.symbolic.analyze import analyze
from spfx_torch.utils.config import Config, DEFAULT
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()


def _spd(n, seed=0):
    """The random SPD matrix of tests/test_mega.py."""
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B @ B.T + sp.diags(np.full(n, n * 0.1)))


MATRICES = {"lap6": lambda: generate.laplacian_3d(6), "spd300": lambda: _spd(300)}
CASES = [(m, d) for m in MATRICES for d in ("float32", "float64")]


@pytest.fixture(scope="module", params=CASES, ids=[f"{m}-{d}" for m, d in CASES])
def plans(request):
    name, dtype = request.param
    A = MATRICES[name]()
    jsym = janalyze(A, JConfig(dtype=dtype))
    jplan = jbuild_plan(jsym, A, JConfig(dtype=dtype))
    sym = analyze(A, Config(dtype=dtype))
    plan = build_plan(sym, A, Config(dtype=dtype))
    return jsym, jplan, sym, plan


def test_config_fields_match():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(Config)}
    assert jf == tf
    assert DEFAULT == Config()


def test_generators_match():
    for k in (3, 6):
        a, b = generate.laplacian_3d(k), jgen.laplacian_3d(k)
        assert (a != b).nnz == 0 and a.shape == b.shape


def test_symbolic_identical(plans):
    jsym, _, sym, _ = plans
    for name in ("perm", "parent", "counts", "sn_start", "sn_of", "sn_ptr",
                 "sn_rows", "sn_level"):
        np.testing.assert_array_equal(getattr(sym, name),
                                      getattr(jsym, name), err_msg=name)
    assert sym.nnzL == jsym.nnzL and sym.flops == jsym.flops


def test_plan_identical(plans):
    _, jplan, _, plan = plans
    ja, ta = plan_arrays(jplan), plan_arrays(plan)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


def test_plan_has_main_path_buckets(plans):
    """The default plan is built of UT update and PC panel buckets only."""
    _, _, _, plan = plans
    kinds = {type(b).__name__ for lp in plan.levels
             for b in lp.updates + lp.panels}
    assert kinds == {"UpdateBucketC", "PanelBucketC"}
    assert all(ub.head_start is not None
               for lp in plan.levels for ub in lp.updates)


def test_bucket_tables_to_device(plans):
    """to(device) returns torch copies of the tables, cached per device."""
    _, _, _, plan = plans
    ub = next(ub for lp in plan.levels for ub in lp.updates)
    t = ub.to("cpu")
    assert t is ub.to(torch.device("cpu"))
    np.testing.assert_array_equal(t[2].numpy(), ub.rstart)
    np.testing.assert_array_equal(t[6].numpy(), ub.tgt_lrow.reshape(-1))
    assert t[6].dtype == torch.int32 and len(t) == 8
    np.testing.assert_array_equal(t[-1].numpy(), ub.tgt_cpos)
    pb = next(pb for lp in plan.levels for pb in lp.panels)
    w, nb, lo = pb.to_u("cpu")
    np.testing.assert_array_equal(w.numpy(), pb.widths)
    np.testing.assert_array_equal(lo.numpy(), pb.slab_lo)


def test_superwindows_inside_storage(plans):
    _, _, _, plan = plans
    check_windows(plan)
    ub = next(ub for lp in plan.levels for ub in lp.updates)
    saved = ub.src_start.copy()
    try:
        ub.src_start[0] = plan.storage - 1
        with pytest.raises(ValueError, match="superwindow"):
            check_windows(plan)
    finally:
        ub.src_start[:] = saved


# --------------------------------------------------------------------------
# LU plans (lu=True): the analysis of A + A^T and the U^T assembly table
# --------------------------------------------------------------------------

def _unsym(n, seed=1):
    """The random unsymmetric matrix of tests/test_mega.py."""
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B + sp.diags(np.abs(B).sum(axis=1).A1 + 1.0))


LU_MATRICES = {"lap6": lambda: generate.laplacian_3d(6),
               "unsym300": lambda: _unsym(300)}
LU_CASES = [(m, d) for m in LU_MATRICES for d in ("float32", "float64")]


@pytest.fixture(scope="module", params=LU_CASES,
                ids=[f"{m}-{d}" for m, d in LU_CASES])
def lu_plans(request):
    name, dtype = request.param
    A = LU_MATRICES[name]()
    jsym = janalyze(A, JConfig(dtype=dtype), symmetrize=True)
    jplan = jbuild_plan(jsym, A, JConfig(dtype=dtype), lu=True)
    sym = analyze(A, Config(dtype=dtype), symmetrize=True)
    plan = build_plan(sym, A, Config(dtype=dtype), lu=True)
    return jsym, jplan, sym, plan


def test_lu_plan_identical(lu_plans):
    jsym, jplan, sym, plan = lu_plans
    for name in ("perm", "sn_start", "sn_ptr", "sn_rows"):
        np.testing.assert_array_equal(getattr(sym, name),
                                      getattr(jsym, name), err_msg=name)
    ja, ta = plan_arrays(jplan), plan_arrays(plan)
    assert "assembly_idx_u" in ta
    assert sorted(ja) == sorted(ta)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert plan.flops == jplan.flops


def test_lu_plan_main_path_and_windows(lu_plans):
    """UT and PC buckets only, and every superwindow inside storage (the
    LU plan's windows serve both arrays)."""
    _, _, _, plan = lu_plans
    kinds = {type(b).__name__ for lp in plan.levels
             for b in lp.updates + lp.panels}
    assert kinds == {"UpdateBucketC", "PanelBucketC"}
    check_windows(plan)
