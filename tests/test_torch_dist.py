"""The port's batch-sharded engines (spfx_torch.dist.factorize:
ShardedCholesky, ShardedLU) against the JAX package's (spfx.dist.factorize)
and against the port's single-device contexts, on the CPU.

The port's ranks are processes in a gloo group (``test_torch_ranks.spawn``:
worlds 2 and 3, one spawn per world size, every case run in it); world 1
runs in the test process, without a group. The JAX side runs here, on a
mesh of the same size out of the eight virtual CPU devices. The matrices
and config are tests/test_dist.py's: ``Config(dtype="float64",
ordering="nd", solve_backend="device")`` at laplacian_3d(6) and (7) and
the perturbed unsymmetric laplacian_3d(6); the UC and rowwin configs on
the same; complex128 on two of tests/test_complex.py's matrices.

Tolerances: Cholesky factors within 1e-12 (tests/test_dist.py's), LU
within 1e-11, float32 within 1e-5 of the largest entry; refined residuals
below 1e-12."""

import functools
import importlib.util

import numpy as np
import pytest
import scipy.sparse as sp

from spfx_torch import Config, Cholesky, LU
from spfx_torch.dist import ShardedCholesky, ShardedLU, make_mesh
from spfx_torch.dist import mesh as dmesh
from spfx_torch.dist.factorize import check_same_plan, task_range
from spfx_torch.io import generate
from spfx_torch.validate import scaled_residual, synth_rhs
from test_torch_ranks import join, load, save, spawn

pytestmark = pytest.mark.skipif(importlib.util.find_spec("jax") is None,
                                reason="the JAX reference needs jax")

CFG = dict(dtype="float64", ordering="nd", solve_backend="device")


def perturbed(k=6):
    """tests/test_dist.py's unsymmetric, diagonally dominant matrix."""
    rng = np.random.default_rng(0)
    A = generate.laplacian_3d(k).tolil()
    n = A.shape[0]
    ii = rng.integers(0, n, 3 * n)
    jj = rng.integers(0, n, 3 * n)
    pert = sp.csc_matrix((0.01 * rng.standard_normal(3 * n), (ii, jj)),
                         shape=(n, n))
    return (A.tocsc() + pert).tocsc()


MATRICES = {
    "lap6": lambda: generate.laplacian_3d(6),
    "lap7": lambda: generate.laplacian_3d(7),
    "pert6": perturbed,
    "herm50": lambda: generate.random_hermitian(50, density=0.08, seed=20),
    "cunsym60": lambda: generate.random_unsym_complex(60, density=0.08,
                                                      seed=30),
}
# name: (LU?, matrix, config fields beyond CFG)
CASES = {
    "chol": (False, "lap6", {}),
    "chol_f32": (False, "lap6", dict(dtype="float32")),
    "lu": (True, "pert6", {}),
    "chol_uc": (False, "lap6", dict(update_tile=0)),
    "lu_uc": (True, "pert6", dict(update_tile=0)),
    "chol_rowwin": (False, "lap6", dict(layout="rowwin")),
    "lu_rowwin": (True, "pert6", dict(layout="rowwin")),
    "chol_c128": (False, "herm50", dict(dtype="complex128")),
    "lu_c128": (True, "cunsym60", dict(dtype="complex128")),
    "chol_lap7": (False, "lap7", {}),
}
WORLDS = {1: ("chol", "lu", "chol_lap7"), 2: tuple(CASES), 3: ("chol",)}
PAIRS = [(w, c) for w, cs in WORLDS.items() for c in cs]


def names(lu):
    return ("Lx", "Ux") if lu else ("L",)


def tol(case):
    lu, _, kw = CASES[case]
    if kw.get("dtype") == "float32":
        return 1e-5
    return 1e-11 if lu else 1e-12


def config(case):
    return Config(**{**CFG, **CASES[case][2]})


def port_case(case, mesh):
    """(arrays by name, refined residual, collective counts, context) of
    one case on this rank."""
    lu, mat, _ = CASES[case]
    A = MATRICES[mat]()
    dmesh.reset_collective_counts()
    ctx = (ShardedLU if lu else ShardedCholesky)(A, config(case), mesh=mesh)
    f = ctx.factorize(A)
    counts = dmesh.collective_counts()
    b = synth_rhs(A, cplx="complex" in ctx.config.dtype)
    res = scaled_residual(A, f.solve(b), b)
    arrays = {n: getattr(f, n).numpy() for n in names(lu)}
    return arrays, res, counts, ctx


def expected_all_reduces(ctx):
    """Per factor array, one all-reduce per level phase that has buckets."""
    phases = sum(bool(lp.updates) + bool(lp.panels)
                 for lp in ctx.plan.levels)
    return phases * (2 if ctx.lu else 1)


def rank_main(world, rank, tmp):
    mesh = join(world, rank, tmp)
    for case in WORLDS[world]:
        arrays, res, counts, ctx = port_case(case, mesh)
        save(tmp, case, rank, residual=res,
             all_reduce=counts["all_reduce"],
             all_reduce_bytes=counts["all_reduce_bytes"],
             want_all_reduce=expected_all_reduces(ctx), **arrays)
    # a rank that planned otherwise: every rank raises
    try:
        check_same_plan(mesh, "rank-%d" % rank if rank else "same")
        refused = "no"
    except RuntimeError as e:
        refused = str(e)
    save(tmp, "refused", rank, message=np.asarray(refused))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> the directory of its ranks' results (world 1: None)."""
    out = {1: None}
    for world in (2, 3):
        out[world] = spawn("test_torch_dist", world,
                           tmp_path_factory.mktemp(f"dist{world}"))
    return out


@functools.lru_cache(maxsize=None)
def world_one(case):
    return port_case(case, make_mesh("d", devices=["cpu"]))


def port_result(ranks, world, case, rank=0):
    if world == 1:
        arrays, res, _, _ = world_one(case)
        return dict(arrays, residual=res)
    return load(ranks[world], case, rank)


@functools.lru_cache(maxsize=None)
def jax_sharded(case, ndev):
    """The JAX package's sharded factor arrays on a mesh of ``ndev``."""
    import jax
    from spfx.dist.factorize import ShardedCholesky as JC, ShardedLU as JL
    from spfx.dist.mesh import make_mesh as jmesh
    from spfx.utils.config import Config as JConfig
    from test_torch_reference import ensure_reference_planner
    ensure_reference_planner()
    lu, mat, kw = CASES[case]
    A = MATRICES[mat]()
    f = (JL if lu else JC)(A, JConfig(**{**CFG, **kw}),
                           mesh=jmesh("d", jax.devices()[:ndev])).factorize(A)
    return {n: np.asarray(getattr(f, n)) for n in names(lu)}


@functools.lru_cache(maxsize=None)
def single_device(case):
    lu, mat, _ = CASES[case]
    A = MATRICES[mat]()
    f = (LU if lu else Cholesky)(A, config(case), device="cpu").factorize(A)
    return {n: getattr(f, n).numpy() for n in names(lu)}


def assert_close(got, want, case, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    t = tol(case)
    if CASES[case][2].get("dtype") == "float32":
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= t, f"{what}: {err:.3e} of the largest entry > {t:g}"
    else:
        np.testing.assert_allclose(got, want, rtol=t, atol=t, err_msg=what)


@pytest.mark.parametrize("world, case", PAIRS, ids=[f"w{w}-{c}"
                                                    for w, c in PAIRS])
def test_sharded_matches_jax(ranks, world, case):
    """The flat factors against JAX's sharded engine on a mesh of the
    same size."""
    got = port_result(ranks, world, case)
    want = jax_sharded(case, world)
    for n in names(CASES[case][0]):
        assert_close(got[n], want[n], case, f"{n} against JAX")


@pytest.mark.parametrize("world, case", PAIRS, ids=[f"w{w}-{c}"
                                                    for w, c in PAIRS])
def test_sharded_matches_single_device(ranks, world, case):
    """The flat factors against the port's single-device context, and the
    refined residual."""
    got = port_result(ranks, world, case)
    want = single_device(case)
    for n in names(CASES[case][0]):
        assert_close(got[n], want[n], case, f"{n} against one device")
    assert got["residual"] < 1e-12


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_hold_one_factor(ranks, world):
    """Every rank ends with the same factor, bit for bit, having made one
    all-reduce per level phase and factor array, and loaded no jax."""
    for case in WORLDS[world]:
        r0 = load(ranks[world], case, 0)
        for r in range(world):
            rr = load(ranks[world], case, r)
            for n in names(CASES[case][0]):
                assert np.array_equal(rr[n], r0[n]), (case, r, n)
            assert int(rr["all_reduce"]) == int(rr["want_all_reduce"]) > 0
            assert not rr["jax_loaded"]


def test_plan_mismatch_raises(ranks):
    for r in range(2):
        msg = str(load(ranks[2], "refused", r)["message"])
        assert "planned the matrix otherwise" in msg, msg


@pytest.mark.parametrize("B, size", [(1, 2), (5, 3), (6, 3), (7, 2),
                                     (2, 8)])
def test_task_range_is_jax_split(B, size):
    """Rank r's tasks are JAX's even split of B padded to a multiple of the
    mesh size, without the padding; together they cover B once."""
    per = -(-B // size)
    got = [task_range(B, size, r) for r in range(size)]
    for r, (lo, hi) in enumerate(got):
        assert (lo, hi) == (min(r * per, B), min((r + 1) * per, B))
    assert sum(hi - lo for lo, hi in got) == B


def test_device_not_the_meshs_raises():
    A = generate.laplacian_3d(3)
    with pytest.raises(ValueError, match="not the mesh's"):
        ShardedCholesky(A, Config(**CFG), mesh=make_mesh(devices=["cpu"]),
                        device="meta")
