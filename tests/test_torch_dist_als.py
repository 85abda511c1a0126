"""The port's row-sharded recommender (spfx_torch.recsys.als over a mesh of
ranks) against the JAX package's ALSModel on a two-device mesh, on the
CPU, on tests/test_torch_als.py's inputs; a world of one rank in a gloo
group against the model without a group; als_bench.scaling() on one rank.

The port's two ranks run in a gloo group (``test_torch_ranks.spawn``);
each runs fit_steps(3) on its blocks of U and V, then gathers the tables
whole and evaluates. Tolerances: the tables within 1e-12 (float64) and
1e-5 (float32) of their largest entry; every rank's metrics and losses
the same."""

import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch.distributed as dist

from spfx_torch.bench import als_bench
from spfx_torch.dist import make_mesh
from spfx_torch.dist import mesh as dmesh
from spfx_torch.recsys import data as rdata
from spfx_torch.recsys.als import ALSConfig, ALSModel
from test_torch_ranks import join, load, save, spawn

pytestmark = pytest.mark.skipif(importlib.util.find_spec("jax") is None,
                                reason="the JAX reference needs jax")

TABLE_TOL = {"float64": 1e-12, "float32": 1e-5}
CASES = [(imp, dt) for imp in (True, False) for dt in ("float64", "float32")]
IDS = [f"{'implicit' if i else 'explicit'}-{d}" for i, d in CASES]


def planted_ratings(seed=3, nu=60, ni=40, k=6):
    """tests/test_torch_als.py's explicit data."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((nu, k)) @ rng.standard_normal((ni, k)).T
    us, its = np.nonzero(rng.random((nu, ni)) < 0.5)
    return rdata.Interactions(nu, ni, us.astype(np.int32),
                              its.astype(np.int32),
                              R[us, its].astype(np.float32))


def fit_data(implicit: bool):
    """tests/test_torch_als.py's fit_data."""
    if implicit:
        return rdata.synthetic(300, 120, avg_degree=20, seed=2), dict(
            rank=16, lam=0.5, alpha=8.0, user_cap=64, item_cap=128,
            chunk=128)
    return planted_ratings(), dict(rank=6, lam=1e-3, implicit=False,
                                   user_cap=40, item_cap=60, chunk=64)


def tag(implicit, dtype):
    return f"{'implicit' if implicit else 'explicit'}_{dtype}"


def trained(implicit, dtype, mesh):
    """A model fitted with fit_steps(3) on ``mesh``: its whole tables, its
    metrics on a held-out split and its losses."""
    inter, kw = fit_data(implicit)
    train, test = inter.split(holdout=2, seed=1)
    m = ALSModel(train, ALSConfig(dtype=dtype, **kw), mesh=mesh)
    m.fit_steps(3)
    U, V = m.full_tables()
    return dict(U=U.numpy(), V=V.numpy(), block=m.U.shape[0],
                loss=m.loss(), full_loss=m.full_implicit_loss(),
                **m.evaluate(test))


def rank_main(world, rank, tmp):
    mesh = join(world, rank, tmp)
    for implicit, dtype in CASES:
        dmesh.reset_collective_counts()
        out = trained(implicit, dtype, mesh)
        save(tmp, tag(implicit, dtype), rank,
             all_gather=dmesh.collective_counts()["all_gather"], **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("test_torch_dist_als", 2, tmp_path_factory.mktemp("als2"))


@functools.lru_cache(maxsize=None)
def jax_trained(implicit, dtype):
    import jax
    from spfx.dist.mesh import make_mesh as jmesh
    from spfx.recsys import data as jdata
    from spfx.recsys.als import ALSConfig as JConfig, ALSModel as JModel
    inter, kw = fit_data(implicit)
    train, _ = inter.split(holdout=2, seed=1)
    jtrain = jdata.Interactions(train.num_users, train.num_items,
                                train.user_ids, train.item_ids,
                                train.ratings)
    m = JModel(jtrain, JConfig(dtype=dtype, **kw),
               mesh=jmesh(devices=jax.devices()[:2]))
    m.fit_steps(3)
    return np.asarray(m.U), np.asarray(m.V)


@pytest.mark.parametrize("implicit, dtype", CASES, ids=IDS)
def test_fit_steps_matches_jax_on_two(ranks, implicit, dtype):
    """Both ranks' whole tables against JAX's on a two-device mesh, each
    rank holding half the padded rows."""
    JU, JV = jax_trained(implicit, dtype)
    for r in range(2):
        got = load(ranks, tag(implicit, dtype), r)
        for name, want in (("U", JU), ("V", JV)):
            g = got[name]
            assert g.shape == want.shape and g.dtype == want.dtype
            err = np.abs(g.astype(np.float64) - want).max() \
                / np.abs(want).max()
            assert err <= TABLE_TOL[dtype], f"{name}: {err:.3e}"
        assert int(got["block"]) * 2 == JU.shape[0]
        # three iterations: two sweeps each, one all-gather a sweep, and
        # the two of full_tables, the loss's, full_implicit_loss's and
        # evaluate's
        assert int(got["all_gather"]) == 6 + 4 * 2
        assert not got["jax_loaded"]


@pytest.mark.parametrize("implicit, dtype", CASES, ids=IDS)
def test_every_rank_evaluates_alike(ranks, implicit, dtype):
    r0, r1 = (load(ranks, tag(implicit, dtype), r) for r in range(2))
    for k in ("U", "V", "loss", "full_loss", "recall@20", "ndcg@10",
              "users_evaluated"):
        assert np.array_equal(r0[k], r1[k]), k


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of one rank in this process, destroyed afterwards."""
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "rdv"), world_size=1, rank=0)
    try:
        yield make_mesh(devices=["cpu"])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("implicit", [True, False],
                         ids=["implicit", "explicit"])
def test_world_of_one_matches_no_group(world_of_one, implicit):
    """In a group of one rank the model all-gathers through gloo, and its
    tables and metrics are the model's without a group, bit for bit."""
    assert world_of_one.group is not None and world_of_one.size == 1
    dmesh.reset_collective_counts()
    grouped = trained(implicit, "float64", world_of_one)
    assert dmesh.collective_counts()["all_gather"] == 6 + 4 * 2
    alone = trained(implicit, "float64", make_mesh(devices=["cpu"]))
    for k, v in alone.items():
        assert np.array_equal(grouped[k], v), k


def test_scaling_on_one_rank(tmp_path, monkeypatch):
    """als_bench.scaling() on one rank runs the bench once and returns an
    efficiency of 1.0, as the JAX bench does on one device."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.delenv("SPFX_ML_PATH", raising=False)
    monkeypatch.setattr(als_bench, "BENCH_CONFIG", dataclasses.replace(
        als_bench.BENCH_CONFIG, rank=8, user_cap=64, item_cap=64))
    out = als_bench.scaling(device="cpu")
    assert out["scaling_efficiency"] == 1.0
    assert out["single"]["devices"] == 1
    assert out["single"]["examples_per_sec"] > 0
    assert os.path.exists(tmp_path / "spfx_als_100k.npz")
