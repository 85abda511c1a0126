"""The port's ALS/iALS recommender (spfx_torch.recsys, spfx_torch.kernels.
dense, spfx_torch.dist.mesh, spfx_torch.bench.als_bench) against the JAX
package on the CPU, on the same inputs.

Every JAX model here is built on a one-device mesh (``make_mesh(devices=
jax.devices()[:1])``), so both sides pad their tables to ``chunk`` rows
alike; the test process has eight virtual CPU devices. Tolerances: the
tables within 1e-9 (float64) and 1e-4 (float32) of their largest entry
after three iterations (the products and solves sum in other orders); the
dense helpers within 1e-12 (float64) and 1e-5 (float32) of the largest
entry; one float64 sweep within 1e-8 of the dense oracle, as the JAX
test."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from spfx.dist.mesh import make_mesh as jmake_mesh
from spfx.kernels import dense as jdense
from spfx.recsys import data as jdata
from spfx.recsys.als import ALSConfig as JConfig, ALSModel as JModel

from spfx_torch.bench import als_bench
from spfx_torch.dist.mesh import make_mesh, round_up
from spfx_torch.interop import als_tables_from_numpy
from spfx_torch.kernels import dense
from spfx_torch.recsys import data as rdata
from spfx_torch.recsys.als import ALSConfig, ALSModel
from test_torch_reference import one_torch_thread

one_torch_thread()

TABLE_TOL = {"float64": 1e-9, "float32": 1e-4}
DENSE_TOL = {"float64": 1e-12, "float32": 1e-5}


def jax_model(inter, **kw):
    return JModel(inter, JConfig(**kw),
                  mesh=jmake_mesh(devices=jax.devices()[:1]))


def port_model(inter, **kw):
    return ALSModel(inter, ALSConfig(**kw), device="cpu")


def close(got, ref, tol, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max() / np.abs(ref).max()
    assert err <= tol, f"{what}: {err:.3e} of the largest entry > {tol:g}"


def dense_ials_oracle(R, U, V, lam, alpha):
    """One exact implicit-ALS user update computed densely (the JAX
    test's oracle)."""
    nu, k = U.shape
    out = np.zeros_like(U)
    for u in range(nu):
        Cu = 1.0 + alpha * R[u]
        A = V.T @ np.diag(Cu) @ V + lam * np.eye(k)
        b = V.T @ (Cu * (R[u] > 0))
        out[u] = np.linalg.solve(A, b)
    return out


def planted_ratings(seed=3, nu=60, ni=40, k=6):
    """Explicit ratings of a planted rank-k model on half the pairs (the JAX
    test's explicit data)."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((nu, k)) @ rng.standard_normal((ni, k)).T
    mask = rng.random((nu, ni)) < 0.5
    us, its = np.nonzero(mask)
    inter = rdata.Interactions(nu, ni, us.astype(np.int32),
                               its.astype(np.int32),
                               R[us, its].astype(np.float32))
    return inter, R, mask


# ---------------------------------------------------------------------------
# data: the copied host layer gives JAX's arrays
# ---------------------------------------------------------------------------

def same_interactions(a, b):
    assert (a.num_users, a.num_items) == (b.num_users, b.num_items)
    for name in ("user_ids", "item_ids", "ratings"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("shape", [(200, 80, 20, 8, 7),
                                   (943, 1682, 106, 12, 0), (50, 7, 5, 2, 3)])
def test_synthetic_matches_jax(shape):
    nu, ni, deg, rank, seed = shape
    same_interactions(rdata.synthetic(nu, ni, deg, rank, seed),
                      jdata.synthetic(nu, ni, deg, rank, seed))


@pytest.mark.parametrize("holdout, seed", [(4, 8), (2, 1)])
def test_split_matches_jax(holdout, seed):
    inter = rdata.synthetic(200, 80, avg_degree=20, seed=7)
    for a, b in zip(inter.split(holdout, seed),
                    jdata.Interactions(inter.num_users, inter.num_items,
                                       inter.user_ids, inter.item_ids,
                                       inter.ratings).split(holdout, seed)):
        same_interactions(a, b)


@pytest.mark.parametrize("cap, pad", [(16, 1), (8, 64), (64, 512)])
def test_padded_rows_matches_jax(cap, pad):
    inter = rdata.synthetic(150, 60, avg_degree=12, seed=4)
    args = (inter.user_ids, inter.item_ids, inter.ratings, inter.num_users,
            cap)
    for got, want in zip(rdata.padded_rows(*args, pad_rows_to=pad),
                         jdata.padded_rows(*args, pad_rows_to=pad)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("fmt", ["csv", "tab"])
def test_load_movielens_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(5)
    rows = np.stack([rng.integers(10, 40, 300), rng.integers(100, 180, 300),
                     rng.integers(1, 6, 300)], axis=1)
    if fmt == "csv":
        path = tmp_path / "ratings.csv"
        np.savetxt(path, rows, fmt="%d", delimiter=",",
                   header="userId,movieId,rating", comments="")
    else:
        path = tmp_path / "u.data"
        np.savetxt(path, np.c_[rows, np.zeros(300, int)], fmt="%d",
                   delimiter="\t")
    same_interactions(rdata.load_movielens(str(path)),
                      jdata.load_movielens(str(path)))


# ---------------------------------------------------------------------------
# the dense helpers
# ---------------------------------------------------------------------------

def spd_batch(B, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, k, k + 3))
    return (X @ X.transpose(0, 2, 1) + k * np.eye(k)).astype(dtype)


def nan_above(A):
    A = A.copy()
    iu = np.triu_indices(A.shape[-1], 1)
    A[:, iu[0], iu[1]] = np.nan
    return A


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B, k", [(7, 64), (3, 1)])
def test_batched_cholesky_matches_jax(B, k, dtype):
    A = spd_batch(B, k, dtype)
    want = np.asarray(jdense.batched_cholesky(jnp.asarray(A)))
    got = dense.batched_cholesky(torch.from_numpy(nan_above(A))).numpy()
    close(got, want, DENSE_TOL[dtype], "L")
    # the lower triangle only: NaN above the diagonal changes nothing
    assert np.array_equal(got, dense.batched_cholesky(
        torch.from_numpy(A)).numpy())
    assert np.array_equal(np.triu(got, 1), np.zeros_like(got))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B, k", [(7, 64), (3, 1)])
def test_batched_chol_solve_matches_jax(B, k, dtype):
    A = spd_batch(B, k, dtype, seed=1)
    rhs = np.random.default_rng(2).standard_normal((B, k, 2)).astype(dtype)
    want = np.asarray(jdense.batched_chol_solve(jnp.asarray(A),
                                                jnp.asarray(rhs)))
    got = dense.batched_chol_solve(torch.from_numpy(nan_above(A)),
                                   torch.from_numpy(rhs)).numpy()
    close(got, want, DENSE_TOL[dtype], "X")
    res = np.abs(A.astype(np.float64) @ got - rhs).max() / np.abs(rhs).max()
    assert res < (1e-10 if dtype == "float64" else 1e-3)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_regularized_gram_matches_jax(dtype):
    Y = np.random.default_rng(3).standard_normal((300, 16)).astype(dtype)
    close(dense.regularized_gram(torch.from_numpy(Y), 0.3).numpy(),
          np.asarray(jdense.regularized_gram(jnp.asarray(Y), 0.3)),
          DENSE_TOL[dtype], "G")


# ---------------------------------------------------------------------------
# the model against JAX's
# ---------------------------------------------------------------------------

def oracle_data(seed=0):
    rng = np.random.default_rng(seed)
    nu, ni = 12, 9
    R = (rng.random((nu, ni)) < 0.4).astype(np.float64)
    us, its = np.nonzero(R)
    inter = rdata.Interactions(nu, ni, us.astype(np.int32),
                               its.astype(np.int32),
                               np.ones(len(us), np.float32))
    return inter, R


def test_user_sweep_matches_jax_and_oracle():
    """One user sweep. The JAX model here is on a two-device mesh, whose
    tables pad to 16 rows as the port's do at this size (chunk 8 x 2
    devices): on a one-device mesh the JAX package's jitted sweep of this
    input is wrong on the CPU (ROADMAP Queue 3)."""
    inter, R = oracle_data()
    kw = dict(rank=4, lam=0.3, alpha=5.0, user_cap=9, item_cap=12, chunk=8,
              dtype="float64", seed=1)
    jm = JModel(inter, JConfig(**kw),
                mesh=jmake_mesh(devices=jax.devices()[:2]))
    m = port_model(inter, **kw)
    V0 = m.V.numpy()[:9]
    assert np.array_equal(m.V.numpy(), np.asarray(jm.V))
    want = np.asarray(jm._sweep(jm.V, jm._u_idx_d, jm._u_rat_d, jm._lam,
                                jm._alpha))
    got = m._sweep(m.V, m._u_idx_d, m._u_rat_d, m._lam, m._alpha).numpy()
    close(got, want, 1e-12, "U against JAX")
    oracle = dense_ials_oracle(R, np.zeros((12, 4)), V0, 0.3, 5.0)
    assert np.abs(got[:12] - oracle).max() < 1e-8
    assert not got[12:].any()


def fit_data(implicit: bool):
    if implicit:
        return rdata.synthetic(300, 120, avg_degree=20, seed=2), dict(
            rank=16, lam=0.5, alpha=8.0, user_cap=64, item_cap=128,
            chunk=128)
    inter, _, _ = planted_ratings()
    return inter, dict(rank=6, lam=1e-3, implicit=False, user_cap=40,
                       item_cap=60, chunk=64)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("implicit", [True, False],
                         ids=["implicit", "explicit"])
def test_fit_steps_matches_jax(implicit, dtype):
    inter, kw = fit_data(implicit)
    jm, m = jax_model(inter, dtype=dtype, **kw), \
        port_model(inter, dtype=dtype, **kw)
    jm.fit_steps(3)
    m.fit_steps(3)
    for name in ("U", "V"):
        got = getattr(m, name)
        assert got.dtype == getattr(torch, dtype)
        close(got.numpy(), np.asarray(getattr(jm, name)), TABLE_TOL[dtype],
              name)
    assert not m.U[inter.num_users:].any() and not m.V[inter.num_items:].any()


def test_high_precision_matches_jax():
    """matmul_precision="high": the port's Gram products run as bf16x3
    (its plain version on the CPU), JAX's CPU ignores the precision."""
    inter, kw = fit_data(True)
    kw = dict(kw, dtype="float32", matmul_precision="high")
    jm, m = jax_model(inter, **kw), port_model(inter, **kw)
    jm.fit_steps(2)
    m.fit_steps(2)
    close(m.U.numpy(), np.asarray(jm.U), 1e-4, "U")
    close(m.V.numpy(), np.asarray(jm.V), 1e-4, "V")


@pytest.mark.parametrize("implicit", [True, False],
                         ids=["implicit", "explicit"])
def test_loss_matches_jax(implicit):
    inter, kw = fit_data(implicit)
    jm, m = jax_model(inter, dtype="float64", **kw), \
        port_model(inter, dtype="float64", **kw)
    jm.step()
    als_tables_from_numpy(m, np.asarray(jm.U), np.asarray(jm.V))
    assert abs(m.loss() - jm.loss()) <= 1e-12 * abs(jm.loss())


def test_full_implicit_loss_matches_dense_objective():
    """The exact iALS objective against its dense sum over every (u, i)
    pair. The JAX package's line raises TypeError for more than one
    interaction (spfx/recsys/als.py:254 closes float()'s parenthesis
    before .sum()); the port sums first."""
    inter, R = oracle_data(seed=4)
    kw = dict(rank=4, lam=0.3, alpha=5.0, user_cap=9, item_cap=12, chunk=8,
              dtype="float64", seed=2)
    jm, m = jax_model(inter, **kw), port_model(inter, **kw)
    m.step()
    U, V = m.U.numpy()[:12], m.V.numpy()[:9]
    C = 1.0 + 5.0 * R
    want = (C * ((R > 0) - U @ V.T) ** 2).sum() \
        + 0.3 * ((U ** 2).sum() + (V ** 2).sum())
    assert abs(m.full_implicit_loss() - want) <= 1e-12 * want
    with pytest.raises(TypeError):
        jm.full_implicit_loss()


def shared_tables(seed=6):
    """A trained JAX model and a port model on the same data and tables."""
    inter = rdata.synthetic(400, 150, avg_degree=15, seed=seed)
    train, test = inter.split(holdout=3, seed=5)
    kw = dict(rank=8, lam=0.3, user_cap=32, item_cap=64, chunk=64)
    jm = jax_model(train, **kw)
    jm.fit_steps(2)
    m = port_model(train, **kw)
    als_tables_from_numpy(m, np.asarray(jm.U), np.asarray(jm.V))
    return jm, m, test


@pytest.mark.parametrize("exclude", [True, False])
def test_topk_matches_jax(exclude):
    """Ties in torch.topk may order differently from lax.top_k: the picked
    items' scores agree in order, and the picked sets agree for every user
    whose k-th and (k+1)-th scores are apart."""
    jm, m, _ = shared_tables()
    k = 10
    want = np.asarray(jm.topk(k, exclude_train=exclude))
    got = m.topk(k, exclude_train=exclude, chunk=128)
    S = m.U.numpy()[:400].astype(np.float64) @ m.V.numpy()[:150].T
    if exclude:
        for u in range(400):
            S[u, m.u_idx[u][m.u_idx[u] >= 0]] = -np.inf
    rows = np.arange(400)[:, None]
    np.testing.assert_allclose(S[rows, got], S[rows, want], rtol=1e-6)
    srt = -np.sort(-S, axis=1)
    apart = srt[:, k - 1] - srt[:, k] > 1e-5
    assert apart.sum() > 300
    for u in np.flatnonzero(apart):
        assert set(got[u]) == set(want[u])
    if exclude:
        assert np.isfinite(S[rows, got]).all()


def test_evaluate_matches_jax():
    jm, m, test = shared_tables(seed=9)
    want, got = jm.evaluate(test), m.evaluate(test)
    assert got.keys() == want.keys()
    assert got["users_evaluated"] == want["users_evaluated"]
    for name in ("recall@20", "ndcg@10"):
        assert abs(got[name] - want[name]) <= 1e-12, name


def test_als_tables_from_numpy():
    jm, m, _ = shared_tables()
    assert np.array_equal(m.U.numpy(), np.asarray(jm.U))
    assert np.array_equal(m.V.numpy(), np.asarray(jm.V))
    m.step()
    jm.step()
    close(m.U.numpy(), np.asarray(jm.U), 1e-4, "U after one step")
    with pytest.raises(ValueError, match="shape"):
        als_tables_from_numpy(m, np.asarray(jm.U)[:-1], np.asarray(jm.V))


# ---------------------------------------------------------------------------
# the JAX package's tests (tests/test_als.py), run on the port
# ---------------------------------------------------------------------------

def test_user_update_matches_dense_oracle():
    inter, R = oracle_data()
    cfg = ALSConfig(rank=4, lam=0.3, alpha=5.0, user_cap=9, item_cap=12,
                    chunk=8, dtype="float64", seed=1)
    m = ALSModel(inter, cfg, device="cpu")
    V0 = m.V.numpy()[:9].copy()
    m.U = m._sweep(m.V, m._u_idx_d, m._u_rat_d, m._lam, m._alpha)
    want = dense_ials_oracle(R, np.zeros((12, 4)), V0, 0.3, 5.0)
    assert np.abs(m.U.numpy()[:12] - want).max() < 1e-8


def test_objective_decreases():
    inter = rdata.synthetic(300, 120, avg_degree=20, seed=2)
    cfg = ALSConfig(rank=16, lam=0.5, alpha=8.0, user_cap=64, item_cap=128,
                    chunk=128, iters=4, dtype="float64")
    m = ALSModel(inter, cfg, device="cpu")
    losses = []
    for _ in range(4):
        m.step()
        losses.append(m.loss())
    assert losses[-1] < losses[0]
    # monotone within tolerance (exact ALS is monotone on the objective)
    for a, b in zip(losses, losses[1:]):
        assert b <= a * (1 + 1e-6)


def test_explicit_als_fits_ratings():
    inter, R, mask = planted_ratings()
    cfg = ALSConfig(rank=6, lam=1e-3, implicit=False, user_cap=40,
                    item_cap=60, chunk=64, dtype="float64")
    m = ALSModel(inter, cfg, device="cpu")
    for _ in range(8):
        m.step()
    pred = (m.U.numpy()[:60] @ m.V.numpy()[:40].T)[mask]
    rel = np.abs(pred - R[mask]).max() / np.abs(R).max()
    assert rel < 0.05


def popularity_recall(train, test, k=20):
    """recall@k of recommending the globally most popular unseen items (the
    JAX test's baseline)."""
    pop = np.bincount(train.item_ids, minlength=train.num_items)
    order = np.argsort(-pop)
    seen, rel = {}, {}
    for u, i in zip(train.user_ids, train.item_ids):
        seen.setdefault(u, set()).add(i)
    for u, i in zip(test.user_ids, test.item_ids):
        rel.setdefault(u, set()).add(i)
    recs = []
    for u, r in rel.items():
        s = seen.get(u, set())
        top = [i for i in order if i not in s][:k]
        recs.append(len(r & set(top)) / min(len(r), k))
    return float(np.mean(recs))


def test_retrieval_beats_popularity():
    inter = rdata.synthetic(500, 200, avg_degree=30, rank=6, seed=4)
    train, test = inter.split(holdout=3, seed=5)
    cfg = ALSConfig(rank=24, lam=0.2, alpha=10.0, user_cap=64, item_cap=256,
                    chunk=256, dtype="float32")
    m = ALSModel(train, cfg, device="cpu")
    m.fit(iters=6)
    metrics = m.evaluate(test)
    assert metrics["recall@20"] > popularity_recall(train, test)
    assert metrics["ndcg@10"] > 0.0


def test_popularity_baseline_vectorised():
    """chip_smoke.py's vectorised popularity baseline (phase 4h) is this
    test's loop."""
    import chip_smoke
    for seed in (4, 5):
        inter = rdata.synthetic(500, 200, avg_degree=30, rank=6, seed=seed)
        train, test = inter.split(holdout=3, seed=5)
        for k in (20, 5):
            assert chip_smoke.popularity_recall(train, test, k) == \
                pytest.approx(popularity_recall(train, test, k), abs=1e-12)


def test_tables_padded_on_one_device_mesh():
    """The JAX test shards the tables over eight devices; the port's mesh
    is one device, and the tables pad to chunk * 1 rows."""
    inter = rdata.synthetic(400, 150, avg_degree=15, seed=6)
    cfg = ALSConfig(rank=8, lam=0.3, user_cap=32, item_cap=64, chunk=64)
    m = ALSModel(inter, cfg, device="cpu")
    assert m.mesh.size == 1 and m.mesh.devices == (torch.device("cpu"),)
    assert m.U.shape[0] == round_up(400, 64) == m.nu
    assert m.V.shape[0] == round_up(150, 64) == m.ni
    m.step()
    assert torch.isfinite(m.U).all()
    assert not m.U[400:].any()


def test_split_disjoint():
    inter = rdata.synthetic(200, 80, avg_degree=20, seed=7)
    tr, te = inter.split(holdout=4, seed=8)
    assert tr.nnz + te.nnz == inter.nnz
    a = set(zip(tr.user_ids.tolist(), tr.item_ids.tolist()))
    b = set(zip(te.user_ids.tolist(), te.item_ids.tolist()))
    assert not (a & b)


def test_fit_steps_matches_fit():
    """The no-wait multi-iteration path computes the same tables as the
    per-iteration step loop."""
    inter = rdata.synthetic(num_users=48, num_items=32, avg_degree=6,
                            rank=3, seed=7)
    cfg = ALSConfig(rank=8, lam=0.2, alpha=5.0, user_cap=16, item_cap=32,
                    chunk=8, iters=3)
    m1 = ALSModel(inter, cfg, device="cpu")
    m1.fit(iters=3)
    m2 = ALSModel(inter, cfg, device="cpu")
    m2.fit_steps(3)
    np.testing.assert_allclose(m2.U.numpy(), m1.U.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(m2.V.numpy(), m1.V.numpy(), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the mesh and the bench
# ---------------------------------------------------------------------------

def test_mesh_larger_than_group_refused():
    mesh = make_mesh(devices=["cpu"])
    assert mesh.axis_names == ("data",) and mesh.size == 1
    with pytest.raises(NotImplementedError, match="init_distributed"):
        make_mesh(devices=["cpu", "cpu"])
    inter = rdata.synthetic(40, 20, avg_degree=5, seed=1)
    m = ALSModel(inter, ALSConfig(rank=4, chunk=8), mesh=mesh)
    assert m.device == torch.device("cpu") and m.nu == 40


def test_bench_data_and_slope(tmp_path, monkeypatch):
    """The bench's synthetic "100k" shape is the JAX bench's, cached in the
    temporary directory; its slope timing runs a model's fit_steps."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.delenv("SPFX_ML_PATH", raising=False)
    inter = als_bench.interactions("100k")
    assert (tmp_path / "spfx_als_100k.npz").exists()
    same_interactions(als_bench.interactions("100k"), inter)
    same_interactions(inter, jdata.synthetic(943, 1682, avg_degree=106,
                                             rank=12, seed=0))
    assert als_bench.BENCH_CONFIG == ALSConfig(
        rank=64, lam=0.3, alpha=10.0, user_cap=256, item_cap=512, chunk=512,
        dtype="float32")
    small = rdata.synthetic(60, 30, avg_degree=6, seed=3)
    m = ALSModel(small, ALSConfig(rank=4, chunk=16), device="cpu")
    per_iter, t = als_bench.slope(m, 2)
    assert per_iter > 0 and set(t) == {1, 3}
