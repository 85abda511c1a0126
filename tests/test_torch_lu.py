"""The port's no-pivot LU on the CPU (plain PyTorch kernel versions) against
the JAX package, with the same seeded numpy inputs: the plain getrf_inv
against the Pallas getrf_inv_lanes in interpret mode, the blocked LU panel
path, one real LU update step, the flat factors of whole factorizations,
and the solve, the static pivot and the interop helper."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

import spfx
from spfx.kernels import blocks as jblocks
from spfx.kernels import pallas_blocks
from spfx.lu import pivot as jpivot
from spfx.plan.schedule import build_plan as jbuild_plan
from spfx.symbolic.analyze import analyze as janalyze

import spfx_torch
from spfx_torch import Config
from spfx_torch.interop import lu_factor_from_numpy, plan_arrays
from spfx_torch.io import generate
from spfx_torch.kernels import blocks, panel
from spfx_torch.lu import pivot
from spfx_torch.plan.schedule import build_plan
from spfx_torch.symbolic.analyze import analyze
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def _unsym(n, seed=1):
    """The random unsymmetric matrix of tests/test_mega.py."""
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B + sp.diags(np.abs(B).sum(axis=1).A1 + 1.0))


# the five CASES of tests/test_lu.py, plus the n = 300 matrix above
MATRICES = {
    "unsym50": lambda: generate.random_unsym(50, density=0.08, seed=10),
    "unsym70": lambda: generate.random_unsym(70, density=0.05, seed=11),
    "sympat60": lambda: generate.random_unsym(60, density=0.1, seed=12,
                                              symmetric_pattern=True),
    "lap2d9": lambda: generate.laplacian_2d(9),
    "diag12": lambda: sp.csc_matrix(sp.diags(np.arange(1.0, 13.0))),
    "unsym300": lambda: _unsym(300),
}
CASES = [(m, d) for m in MATRICES for d in DTYPES]


def _cfg(dtype, **kw):
    return Config(dtype=dtype, ordering="nd", **kw)


# --------------------------------------------------------------------------
# getrf_inv
# --------------------------------------------------------------------------

def _lu_blocks(B, nb, seed):
    """Diagonally dominant blocks with both triangles filled."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((B, nb, nb))
    return D + (np.abs(D).sum(2)[:, :, None] + 1.0) * np.eye(nb)[None]


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10), ("float32", 1e-5)])
@pytest.mark.parametrize("nb,every", [(32, False), (16, False), (32, True)],
                         ids=["32", "16", "32-every-width"])
def test_getrf_inv_matches_pallas(dtype, tol, nb, every):
    """Plain getrf_inv vs getrf_inv_lanes (interpret mode), transposed to
    the TPU's (nb, nb, B) layout; B a power of two (lanes_slab cuts other
    batch sizes): 8 blocks, or 64 holding every width 0..nb and seeded
    ones. f32 tolerance, relative to each output's largest entry: both are
    float32 recurrences of nb steps summed in other orders."""
    npd, _ = DTYPES[dtype]
    if every:
        D = _lu_blocks(64, nb, 23).astype(npd)
        w = np.concatenate([np.arange(nb + 1), np.random.default_rng(23)
                            .integers(0, nb + 1, 63 - nb)]).astype(np.int32)
    else:
        D = _lu_blocks(8, nb, 21).astype(npd)
        w = np.array([0, 1, nb - 1, nb, 5, nb // 2, nb, 3], np.int32)
    outs = pallas_blocks.getrf_inv_lanes(
        jnp.asarray(w), jnp.asarray(np.transpose(D, (1, 2, 0))))
    mine = panel.getrf_inv(torch.from_numpy(w), torch.from_numpy(D))
    for name, ref, got in zip(("L", "U", "Linv", "Uinv"), outs, mine):
        ref = np.transpose(np.asarray(ref), (2, 0, 1))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max(), err_msg=name)


def test_getrf_inv_contract():
    """Reconstruction on the live part, and the padding contract: wrel == 0
    gives L = U = 0 and Linv = Uinv = I; padding rows of the inverses are
    unit rows."""
    nb = 32
    D = _lu_blocks(4, nb, 22)
    w = np.array([0, 1, 31, 32], np.int32)
    L, U, Li, Ui = (t.numpy() for t in panel.getrf_inv(
        torch.from_numpy(w), torch.from_numpy(D)))
    assert (L[0] == 0).all() and (U[0] == 0).all()
    np.testing.assert_array_equal(Li[0], np.eye(nb))
    np.testing.assert_array_equal(Ui[0], np.eye(nb))
    for b, wb in enumerate(w):
        Dl = D[b][:wb, :wb]
        np.testing.assert_allclose(L[b][:wb, :wb] @ U[b][:wb, :wb], Dl,
                                   atol=1e-12 * np.abs(Dl).max(initial=1))
        np.testing.assert_array_equal(np.diag(L[b])[:wb], 1.0)
        assert (np.triu(L[b], 1) == 0).all() and (np.tril(U[b], -1) == 0).all()
        for M in (L[b], U[b]):
            assert (M[wb:] == 0).all() and (M[:, wb:] == 0).all()
        pad = np.diag((np.arange(nb) >= wb).astype(float))
        np.testing.assert_allclose(Li[b] @ (L[b] + pad), np.eye(nb),
                                   atol=1e-12)
        np.testing.assert_allclose((U[b] + pad) @ Ui[b], np.eye(nb),
                                   atol=1e-12)
        np.testing.assert_array_equal(Li[b][wb:], np.eye(nb)[wb:])
        np.testing.assert_array_equal(Ui[b][wb:], np.eye(nb)[wb:])


def test_getrf_inv_rejects_bad_input():
    D = torch.zeros(2, 32, 32)
    w = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="wrel"):
        panel.getrf_inv(torch.zeros(2, dtype=torch.int64), D)
    with pytest.raises(ValueError, match="nb"):
        panel.getrf_inv(w, torch.zeros(2, 64, 64))
    with pytest.raises(ValueError, match="contiguous"):
        panel.getrf_inv(w, D.transpose(1, 2))
    with pytest.raises(TypeError):
        panel.getrf_inv(w, D.half())


# --------------------------------------------------------------------------
# blocked LU panel path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,cp,rbp,seed", [(8, 16, 32, 7), (4, 64, 64, 8),
                                           (2, 128, 32, 9), (8, 32, 0, 10)])
def test_lu_deltas_blocked_matches_jax(B, cp, rbp, seed):
    """The cases of tests/test_panel_kernels.py: the port's blocked LU
    panel deltas vs the JAX blocked path (Pallas getrf_inv_lanes
    interpreted), f64."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, cp + 1, B).astype(np.int32)
    nb = rng.integers(0, rbp + 1, B).astype(np.int32) if rbp \
        else np.zeros(B, np.int32)
    cm = np.arange(cp)[None, :] < w[:, None]
    Dh = rng.standard_normal((B, cp, cp))
    Dh = Dh + (np.abs(Dh).sum(2)[:, :, None] + 1.0) * np.eye(cp)[None]
    DL = np.tril(Dh) * cm[:, None, :] * cm[:, :, None]
    DU = np.swapaxes(np.triu(Dh, 1), 1, 2) * cm[:, None, :] * cm[:, :, None]
    if rbp:
        BL = rng.standard_normal((B, rbp, cp)) * cm[:, None, :]
        BU = rng.standard_normal((B, rbp, cp)) * cm[:, None, :]
    else:
        BL = BU = np.zeros((B, 0, cp))
    args = (DL, DU, BL, BU, w, nb)
    ref = jblocks._lu_deltas_blocked(*(jnp.asarray(a) for a in args),
                                     cp=cp, rbp=rbp)
    got = blocks._lu_deltas_blocked(*(torch.from_numpy(a) for a in args),
                                    cp, rbp)
    for name, r, g in zip(("dDL", "dBL", "dDU", "dBU"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-10, err_msg=name)


# --------------------------------------------------------------------------
# one LU UT update step on a real plan
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["lap6", "unsym300"])
def lu_plan(request):
    """The JAX package's LU plan, the port's (identical tables, see
    test_torch_plan.py) and two seeded flat arrays of the storage size:
    every slot holds a value, padding included, so any gather, mask or
    crossed-product mistake shows."""
    A = generate.laplacian_3d(6) if request.param == "lap6" else _unsym(300)
    cfg = spfx.Config(dtype="float64")
    plan = jbuild_plan(janalyze(A, cfg, symmetrize=True), A, cfg, lu=True)
    tcfg = Config(dtype="float64")
    tplan = build_plan(analyze(A, tcfg, symmetrize=True), A, tcfg, lu=True)
    rng = np.random.default_rng(8)
    return plan, tplan, rng.standard_normal((2, plan.storage))


def _largest_ut(plan, tplan):
    """The UT bucket with the most live tasks, in both plans."""
    ubs = [ub for lp in plan.levels for ub in lp.updates]
    tubs = [ub for lp in tplan.levels for ub in lp.updates]
    i = max(range(len(ubs)), key=lambda i: int((ubs[i].kw > 0).sum()))
    return ubs[i], tubs[i]


@pytest.mark.parametrize("dtype,steps", [
    ("float32", "largest"), ("float64", "largest"),
    ("float32", "every"), ("float64", "every")],
    ids=["float32", "float64", "float32-every", "float64-every"])
def test_lu_ut_step_matches_jax(lu_plan, dtype, steps):
    """update rows + extend-add on both arrays, in place, vs
    apply_updates_lu_t: the largest UT step, or every UT step of the plan
    in turn. Each step writes only its slab. f32 tolerance: the JAX
    extend-add sums a group's rows that share a slab row before
    subtracting; the port subtracts them one by one."""
    plan, tplan, flat = lu_plan
    npd, _ = DTYPES[dtype]
    fl, fu = flat[0].astype(npd), flat[1].astype(npd)
    pairs = ([_largest_ut(plan, tplan)] if steps == "largest" else list(zip(
        [ub for lp in plan.levels for ub in lp.updates],
        [ub for lp in tplan.levels for ub in lp.updates])))
    Lj, Uj = jnp.asarray(fl), jnp.asarray(fu)
    Lt, Ut = torch.from_numpy(fl.copy()), torch.from_numpy(fu.copy())
    for ub, tub in pairs:
        Lj, Uj = jblocks.apply_updates_lu_t(
            Lj, Uj, *ub.dev(), mp=ub.mp, kp=ub.kp, csp=ub.csp,
            srows=ub.slab_rows)
        kw, mrows, rstart, src, head, *_, cpos = tub.to("cpu")
        before = Lt.clone(), Ut.clone()
        out = blocks.apply_updates_lu_t(
            Lt, Ut, kw, mrows, rstart, src, head, int(ub.slab_lo[0]),
            tub.to("cpu")[6], cpos, mp=ub.mp, kp=ub.kp, csp=ub.csp,
            srows=ub.slab_rows)
        assert out[0] is Lt and out[1] is Ut             # in place
        lo = int(ub.slab_lo[0])
        hi = lo + ub.slab_rows * ub.csp
        for got, prev in zip(out, before):
            assert torch.equal(got[:lo], prev[:lo])
            assert torch.equal(got[hi:], prev[hi:])
    tol = 1e-12 if dtype == "float64" else 1e-5
    for ref, got, start in ((Lj, Lt, fl), (Uj, Ut, fu)):
        ref = np.asarray(ref)
        assert (ref != start).sum() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())


def test_factor_panels_lu_in_place(lu_plan):
    """A PC step writes only its bucket's uniform block, on both arrays."""
    _, tplan, flat = lu_plan
    pb = max((pb for lp in tplan.levels for pb in lp.panels),
             key=lambda pb: pb.cp)
    lo = int(pb.slab_lo[0])
    hi = lo + len(pb.widths) * (pb.cp + pb.rbp) * pb.cp
    Lx, Ux = (torch.from_numpy(f * 1e-3) for f in flat)
    for t in (Lx, Ux):
        t[lo:hi].view(-1, pb.cp + pb.rbp, pb.cp)[:, :pb.cp, :] += \
            10 * torch.eye(pb.cp, dtype=t.dtype)
    before = Lx.clone(), Ux.clone()
    w, nb, _ = pb.to_u("cpu")
    blocks.factor_panels_lu_u(Lx, Ux, w, nb, lo, pb.cp, pb.rbp)
    for t, t0 in zip((Lx, Ux), before):
        assert torch.isfinite(t).all()
        assert torch.equal(t[:lo], t0[:lo]) and torch.equal(t[hi:], t0[hi:])
        assert not torch.equal(t[lo:hi], t0[lo:hi])


# --------------------------------------------------------------------------
# whole factorizations
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=CASES,
                ids=[f"{m}-{d}" for m, d in CASES])
def pair(request):
    """(A, dtype, JAX factor, port context, port factor), computed once."""
    name, dtype = request.param
    A = MATRICES[name]()
    jf = spfx.LU(A, spfx.Config(dtype=dtype, ordering="nd")).factorize(A)
    ctx = spfx_torch.LU(A, _cfg(dtype), device="cpu")
    return A, dtype, jf, ctx, ctx.factorize(A)


def test_flat_factors_match_jax(pair):
    """f64: rtol 1e-10, atol 1e-12 max. f32: max abs difference <= 1e-4
    max, because on the CPU the JAX panels take XLA's getrf_nopiv expander
    while the port takes the blocked NB = 32 path, and the two extend-adds
    sum in other orders."""
    _, dtype, jf, _, f = pair
    for ref, got in ((jf.Lx, f.Lx), (jf.Ux, f.Ux)):
        ref = np.asarray(ref)
        got = got.numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype
        m = np.abs(ref).max()
        if dtype == "float64":
            np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12 * m)
        else:
            assert np.abs(got - ref).max() <= 1e-4 * m


def test_LU_equals_PAPt(pair):
    A, dtype, _, _, f = pair
    L, U = f.LU_sparse()
    p = f.sym.perm
    Ap = A[p][:, p].toarray()
    tol = 1e-9 if dtype == "float64" else 1e-5
    assert np.abs(L @ U - Ap).max() < tol * np.abs(Ap).max()
    assert np.allclose(L.diagonal(), 1.0)
    assert abs(sp.triu(L, 1)).nnz == 0
    assert abs(sp.tril(U, -1)).nnz == 0


def test_lu_solve_residual(pair):
    """f64 without refinement, f32 after the default refinement."""
    A, dtype, _, _, f = pair
    b = spfx_torch.synth_rhs(A)
    x0 = f.solve(b, refine=0)
    if dtype == "float64":
        assert spfx_torch.scaled_residual(A, x0, b) <= 1e-12
    else:
        assert spfx_torch.scaled_residual(A, x0, b) < 1e-4
    assert spfx_torch.scaled_residual(A, f.solve(b), b) <= 1e-12


def test_interop_lu_factor_solves_same_x(pair):
    """The JAX factor, carried into the port, solves to the JAX
    solution."""
    A, _, jf, ctx, _ = pair
    b = spfx_torch.synth_rhs(A)
    f = lu_factor_from_numpy(ctx, np.asarray(jf.Lx), np.asarray(jf.Ux),
                             "cpu")
    np.testing.assert_allclose(f.solve(b), jf.solve(b), rtol=1e-12,
                               atol=1e-14)
    with pytest.raises(ValueError, match="plan stores"):
        lu_factor_from_numpy(ctx, np.zeros(ctx.plan.storage + 1),
                             np.asarray(jf.Ux), "cpu")


def test_lu_refactorize_same_context(pair):
    A, _, _, ctx, f = pair
    f2 = ctx.factorize(A)
    assert torch.equal(f2.Lx, f.Lx) and torch.equal(f2.Ux, f.Ux)
    assert ctx.factorize_time > 0 and ctx.plan_time > 0


def test_lu_multiple_rhs():
    A = generate.random_unsym(40, density=0.1, seed=13)
    f = spfx_torch.lu(A, _cfg("float64"), device="cpu")
    b = np.random.default_rng(5).standard_normal((40, 3))
    x = f.solve(b, refine=0)
    assert x.shape == (40, 3)
    assert np.abs(A @ x - b).max() < 1e-9


def test_lu_matches_cholesky_on_spd():
    A = generate.laplacian_2d(8)
    b = spfx_torch.synth_rhs(A)
    x_lu = spfx_torch.lu(A, _cfg("float64"), device="cpu").solve(b, refine=0)
    x_ch = spfx_torch.cholesky(A, _cfg("float64"), device="cpu").solve(
        b, refine=0)
    assert np.abs(x_lu - x_ch).max() < 1e-9 * np.abs(x_ch).max()


def test_static_pivot_matches_jax():
    """The copied static pivot gives the JAX package's permutation."""
    A = generate.random_unsym(80, density=0.06, seed=13)
    B = sp.csc_matrix(A[np.random.default_rng(3).permutation(80)])
    rperm = pivot.static_pivot(B)
    np.testing.assert_array_equal(rperm, jpivot.static_pivot(B))
    assert pivot.diag_dominance(B[rperm]) == jpivot.diag_dominance(B[rperm])
    assert pivot.diag_dominance(B[rperm]) > pivot.diag_dominance(B)


def test_lu_static_pivot_solves_scrambled():
    A = generate.random_unsym(90, density=0.06, seed=14)
    B = sp.csc_matrix(A[np.random.default_rng(4).permutation(90)])
    b = spfx_torch.synth_rhs(B)
    f = spfx_torch.lu(B, _cfg("float64", static_pivot=True), device="cpu")
    assert spfx_torch.scaled_residual(B, f.solve(b, refine=0), b) < 1e-12
    # refinement runs against the unpermuted user matrix
    assert spfx_torch.scaled_residual(B, f.solve(b), b) < 1e-14


def test_lu_reuses_symbolic():
    """On a symmetric pattern the Cholesky analysis is the LU one: a
    context given it builds the plan LU would build."""
    A = generate.laplacian_3d(6)
    cfg = Config(dtype="float32")
    sym = spfx_torch.Cholesky(A, cfg, device="cpu").sym
    a = plan_arrays(spfx_torch.LU(A, cfg, sym=sym, device="cpu").plan)
    b = plan_arrays(spfx_torch.LU(A, cfg, device="cpu").plan)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_lu_engines_calls_and_mega_agree():
    A = generate.random_unsym(60, density=0.08, seed=15)
    a = spfx_torch.lu(A, Config(dtype="float64", engine="calls"),
                      device="cpu")
    b = spfx_torch.lu(A, Config(dtype="float64", engine="mega"),
                      device="cpu")
    assert torch.equal(a.Lx, b.Lx) and torch.equal(a.Ux, b.Ux)


def test_lu_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spfx_torch.lu(generate.laplacian_3d(3))

