"""For real inputs the reference and the bound arithmetic return what they
returned before the precision ladder, bit for bit: the literals below are
the values of commit 1f6ed06 (the parent of the ladder) for the two
configurations at grid 12, on the CPU. The plans come from the program's
planner; ``PLAN`` pins their shape, so that a plan that changed reads as
that and not as a change of the arithmetic."""

import json

import numpy as np
import pytest
import scipy.sparse as sp

from portbench import bounds, reference, spec as specs
from portbench.tests.test_portbench_correct import dense_reading

CONFIGS = ("poisson3d-48-chol-f32", "convdiff3d-48-lu-f32")
GRID = 12

DENSE = {  # (full float32, 10 bits)
    "poisson3d-48-chol-f32": (9.478444385502316e-08, 1.2335392794511028e-05),
    "convdiff3d-48-lu-f32": (8.199251462778093e-08, 1.2230499042857578e-05),
}
SEEDED = {  # (factor_backward_error, scaled_residual)
    "poisson3d-48-chol-f32": (0.7077596463543266, 0.6821432387347895),
    "convdiff3d-48-lu-f32": (0.7691271939331547, 0.5308459198853583),
}
BOUNDS = {  # {kernel: path_bound_ms}
    "poisson3d-48-chol-f32": {"window_gather2": 0.0066076465671641785,
                              "potrf_inv": 0.002945711044776119},
    "convdiff3d-48-lu-f32": {"window_gather2": 0.013215293134328357,
                             "getrf_inv": 0.005887935522388059},
}
PLAN = [24, 43, 28]     # levels, UT steps, PC steps


def config(name):
    with open(f"{specs.ROOT}/portbench/configs/{name}.json") as fh:
        return json.load(fh)


def family(conf):
    return specs.load_module("families", conf["family"]).Family(
        dict(conf, grid=GRID))


@pytest.mark.parametrize("name", CONFIGS)
def test_dense_readings(name):
    conf = config(name)
    assert (dense_reading(conf, None), dense_reading(conf, 10)) == \
        DENSE[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_seeded_checks(name):
    """Both checks on seeded float32 values: a factor on the lower pattern
    of P A P^T under a seeded permutation, and a solution."""
    conf = config(name)
    f = family(conf)
    A = f.matrix(f.values(np.random.default_rng(3), 1)[0])
    n = A.shape[0]
    g = np.random.default_rng(17)
    p = g.permutation(n)
    low = sp.tril(A[p][:, p]).tocoo()
    lv = g.standard_normal(low.nnz).astype(np.float32)
    uv = g.standard_normal(low.nnz).astype(np.float32) if conf[
        "kind"] == "lu" else None
    fbe = reference.factor_backward_error(A, p, low.row, low.col, lv, uv,
                                          probes=3, seed=29)
    X = g.standard_normal((n, 3)).astype(np.float32)
    B = g.standard_normal((n, 3))
    assert (fbe, reference.scaled_residual(A, X, B)) == SEEDED[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_path_bounds(name):
    import spfx_torch
    conf = config(name)
    f = family(conf)
    lu = conf["kind"] == "lu"
    plan = (spfx_torch.LU if lu else spfx_torch.Cholesky)(
        f.matrix(f.middle()), spfx_torch.Config(), device="cpu").plan
    assert [len(plan.levels), sum(len(lp.updates) for lp in plan.levels),
            sum(len(lp.panels) for lp in plan.levels)] == PLAN
    got = {k: bounds.path_bound_ms(plan, k, "float32", 2 if lu else 1)
           for k in BOUNDS[name]}
    assert got == BOUNDS[name]
