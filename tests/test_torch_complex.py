"""Complex factorizations of the port against the JAX package: the Hermitian
Cholesky (the reference's zpotrf/zherk line) and the no-pivot complex LU
(zgetrf), complex64 and complex128, under every engine and layout (after
tests/test_complex.py).

Flat factors slot by slot against spfx's on the same plan; L L^H = P A P^T
and L U = P A P^T; refined residuals; complex on real input against the
real solve; the panel routes (a complex class always takes the blocked
path); the plain diagonal-block versions against lax.linalg at every width;
interop, checkpoints both ways and the CLI. Tolerances: 1e-12 (complex128)
and 1e-5 (complex64) of the array's largest entry, the real tests'
tolerances for f64 and f32: both sides take the same recurrences with
sums in other orders."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytest.importorskip("jax")
import jax.numpy as jnp
from jax import lax

import spfx
from spfx import checkpoint as jcheckpoint

import spfx_torch
import spfx_torch.__main__ as cli
from spfx_torch import Config, checkpoint
from spfx_torch.interop import factor_from_numpy, lu_factor_from_numpy
from spfx_torch.io import generate, matrix_market
from spfx_torch.kernels import panel, route
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

DTYPES = ("complex64", "complex128")
TOL = {"complex64": 1e-5, "complex128": 1e-12}
CONFIGS = {"default": {}, "uc": dict(update_tile=0),
           "rowwin": dict(layout="rowwin"),
           "rowwin_fused": dict(layout="rowwin", engine="fused"),
           "calls": dict(engine="calls")}


def _lap2d_complex():
    return sp.csc_matrix(generate.laplacian_2d(8).astype(np.complex128))


# the matrices of tests/test_complex.py, by kind
MATRICES = {
    "herm50-20": (False, lambda: generate.random_hermitian(
        50, density=0.08, seed=20)),
    "herm50-21": (False, lambda: generate.random_hermitian(
        50, density=0.08, seed=21)),
    "lap2d8": (False, _lap2d_complex),
    "unsym60-30": (True, lambda: generate.random_unsym_complex(
        60, density=0.08, seed=30)),
    "unsym72-31": (True, lambda: generate.random_unsym_complex(
        72, density=0.06, seed=31)),
    "unsym72-32": (True, lambda: generate.random_unsym_complex(
        72, density=0.06, seed=32)),
}


def _names(lu):
    return ("Lx", "Ux") if lu else ("L",)


def _factors(name, dtype, **kw):
    """(A, lu, the JAX factor, the port's CPU factor) under one Config."""
    lu, make = MATRICES[name]
    A = make()
    jk = spfx.lu if lu else spfx.cholesky
    tk = spfx_torch.lu if lu else spfx_torch.cholesky
    return (A, lu, jk(A, spfx.Config(dtype=dtype, **kw)),
            tk(A, Config(dtype=dtype, **kw), device="cpu"))


def _rhs(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(MATRICES))
def test_flat_factors_match_jax(name, dtype, cfg):
    """Every slot of the flat factor(s) against spfx's, and the refined
    residual of a complex right-hand side <= 1e-12."""
    A, lu, fj, ft = _factors(name, dtype, **CONFIGS[cfg])
    for nm in _names(lu):
        want = np.asarray(getattr(fj, nm))
        got = getattr(ft, nm)
        assert got.dtype == getattr(torch, dtype)
        got = got.numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= TOL[dtype] * scale, nm
    b = _rhs(A.shape[0])
    assert spfx_torch.scaled_residual(A, ft.solve(b), b) <= 1e-12


@pytest.mark.parametrize("seed", [20, 21])
def test_LLH_equals_PAPT(seed):
    A = generate.random_hermitian(50, density=0.08, seed=seed)
    f = spfx_torch.cholesky(A, Config(dtype="complex128", ordering="nd"),
                            device="cpu")
    L = f.L_sparse()
    p = f.sym.perm
    Ap = A[p][:, p].toarray()
    assert np.abs(L @ L.conj().T - Ap).max() < 1e-10 * np.abs(Ap).max()
    # the diagonal of a Hermitian factor is real and positive
    d = L.diagonal()
    assert np.all(d.imag == 0) and np.all(d.real > 0)
    assert np.isclose(f.logdet(), np.linalg.slogdet(Ap)[1])


def test_complex_lu_equals_PAPT():
    A = generate.random_unsym_complex(60, density=0.08, seed=30)
    f = spfx_torch.lu(A, Config(dtype="complex128", ordering="nd"),
                      device="cpu")
    L, U = f.LU_sparse()
    p = f.sym.perm
    Ap = A[p][:, p].toarray()
    assert np.abs(L @ U - Ap).max() < 1e-10 * np.abs(Ap).max()
    assert np.allclose(L.diagonal(), 1.0)
    assert abs(sp.triu(L, 1)).nnz == 0
    assert abs(sp.tril(U, -1)).nnz == 0


@pytest.mark.parametrize("backend", ["auto", "host", "device"])
@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_refined_residual_any_backend(lu, backend):
    """A complex factor solves on the device whatever the backend, as the
    JAX package's does; refinement runs in complex128."""
    A = generate.random_unsym_complex(72, density=0.06, seed=31) if lu \
        else generate.random_hermitian(64, density=0.06, seed=22)
    kind = spfx_torch.lu if lu else spfx_torch.cholesky
    f = kind(A, Config(dtype="complex64", solve_backend=backend),
             device="cpu")
    assert not f._use_host_solve()
    b = _rhs(A.shape[0], 1)
    x = f.solve(b)
    assert x.dtype == np.complex128
    assert spfx_torch.scaled_residual(A, x, b) <= 1e-12


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_complex_on_real_input_matches_real(lu):
    """A real matrix factorized as complex128: the solution of a real
    right-hand side has no imaginary part and is the real solve's."""
    A = generate.random_unsym(50, density=0.08, seed=33) if lu \
        else generate.laplacian_2d(8)
    kind = spfx_torch.lu if lu else spfx_torch.cholesky
    Ac = sp.csc_matrix(A.astype(np.complex128))
    fc = kind(Ac, Config(dtype="complex128", ordering="nd"), device="cpu")
    fr = kind(A, Config(dtype="float64", ordering="nd"), device="cpu")
    for nm in _names(lu):
        c, r = getattr(fc, nm).numpy(), getattr(fr, nm).numpy()
        assert np.abs(c.imag).max() == 0
        assert np.abs(c.real - r).max() <= 1e-12 * np.abs(r).max()
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    xc, xr = fc.solve(b), fr.solve(b)
    assert np.abs(xc.imag).max() < 1e-10
    assert np.abs(xc.real - xr).max() < 1e-8


@pytest.mark.parametrize("mode", ["lanes", "wide", "mixed"])
@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_panel_routes_leave_complex_blocked(monkeypatch, lu, mode):
    """A complex class routes to the blocked path under every mode, so the
    factor is the blocked one's bit for bit; a real class still takes the
    mode's kernel."""
    A = generate.random_unsym_complex(72, density=0.06, seed=32) if lu \
        else _lap2d_complex()
    kind = spfx_torch.lu if lu else spfx_torch.cholesky
    base = kind(A, Config(dtype="complex128"), device="cpu")
    monkeypatch.setenv(route.ENV, mode)
    assert route.route_panel(32, 8, 4, 16, lu, cplx=True) == "blocked"
    assert route.route_panel(32, 8, 4, 8, lu) != "blocked"
    f = kind(A, Config(dtype="complex128"), device="cpu")
    for nm in _names(lu):
        assert torch.equal(getattr(f, nm), getattr(base, nm))


def _jax_potrf_inv(w, D):
    """lax.linalg's (L, L^{-1}) of the masked block: D's lower triangle on
    the live w x w part (Hermitian), identity on the padding."""
    nb = D.shape[0]
    M = np.eye(nb, dtype=D.dtype)
    M[:w, :w] = np.tril(D[:w, :w]) + np.tril(D[:w, :w], -1).conj().T
    L = np.asarray(lax.linalg.cholesky(jnp.asarray(M)))
    Linv = np.asarray(lax.linalg.triangular_solve(
        jnp.asarray(L), jnp.eye(nb, dtype=D.dtype), left_side=True,
        lower=True))
    live = np.zeros((nb, nb), bool)
    live[:w, :w] = True
    return np.where(live, L, 0), Linv


def _jax_getrf_inv(w, D):
    """lax.linalg's no-pivot (L, U, L^{-1}, U^{-1}) of the masked block
    (lu with pivots checked to be the identity: the blocks are diagonally
    dominant)."""
    nb = D.shape[0]
    M = np.eye(nb, dtype=D.dtype)
    M[:w, :w] = D[:w, :w]
    lu_, piv, _ = lax.linalg.lu(jnp.asarray(M))
    assert np.array_equal(np.asarray(piv), np.arange(nb))
    lu_ = np.asarray(lu_)
    Lu = np.tril(lu_, -1) + np.eye(nb, dtype=D.dtype)
    U = np.triu(lu_)
    eye = jnp.eye(nb, dtype=D.dtype)
    Linv = np.asarray(lax.linalg.triangular_solve(
        jnp.asarray(Lu), eye, left_side=True, lower=True, unit_diagonal=True))
    Uinv = np.asarray(lax.linalg.triangular_solve(
        jnp.asarray(U), eye, left_side=True, lower=False))
    live = np.zeros((nb, nb), bool)
    live[:w, :w] = True
    return np.where(live, Lu, 0), np.where(live, U, 0), Linv, Uinv


@pytest.mark.parametrize("w", range(33))
def test_plain_diag_blocks_match_lax(w):
    """potrf_inv_plain and getrf_inv_plain on complex blocks at width w
    (nb = 32, junk above the diagonal for potrf) against lax.linalg on the
    same masked blocks, complex128 and complex64."""
    rng = np.random.default_rng(w)
    nb = 32
    X = rng.standard_normal((nb, nb)) + 1j * rng.standard_normal((nb, nb))
    H = X @ X.conj().T + nb * np.eye(nb)
    Dp = np.tril(H) + np.triu(np.full((nb, nb), 1e3 + 1e3j), 1)
    Du = (rng.standard_normal((nb, nb)) + 1j * rng.standard_normal((nb, nb)))
    Du = Du + np.diag(np.abs(Du).sum(1) + 1)
    for dtype, tol in (("complex128", 1e-12), ("complex64", 1e-5)):
        wrel = torch.tensor([w], dtype=torch.int32)
        got = panel.potrf_inv_plain(wrel, torch.tensor(Dp[None],
                                                       dtype=getattr(torch,
                                                                     dtype)))
        want = _jax_potrf_inv(w, Dp.astype(dtype))
        for g, r in zip(got, want):
            assert np.abs(g[0].numpy() - r).max() <= tol * max(
                1.0, np.abs(r).max())
        got = panel.getrf_inv_plain(wrel, torch.tensor(
            Du[None], dtype=getattr(torch, dtype)))
        want = _jax_getrf_inv(w, Du.astype(dtype))
        for g, r in zip(got, want):
            assert np.abs(g[0].numpy() - r).max() <= tol * max(
                1.0, np.abs(r).max())


@pytest.mark.parametrize("w", range(33))
def test_plain_potrf_inv_c_contract_edges(w):
    """The contract's edges of potrf_inv_plain on one complex block (B = 1,
    nb = 32) at width w, complex64 and complex128, exactly: L's diagonal
    stored real, L lower triangular and zero on the padding rows and
    columns, Linv lower triangular with unit rows on the padding and zeros
    in the padding columns of the live rows, and I at w = 0; then
    L L^H = D' and Linv (L + the padding's identity) = I on the live part
    within the tolerance of the largest entry. The card's kernel
    (csrc/potrf_inv_c.cu) is held to this plain version by chip_smoke.py
    phase 3f."""
    rng = np.random.default_rng(100 + w)
    nb = 32
    X = rng.standard_normal((nb, nb)) + 1j * rng.standard_normal((nb, nb))
    D = np.tril(X @ X.conj().T + nb * np.eye(nb))
    D = D + np.triu(np.full((nb, nb), 1e3 + 1e3j), 1)
    wrel = torch.tensor([w], dtype=torch.int32)
    pad = np.arange(nb) >= w
    for dtype in DTYPES:
        L, Li = (t[0].numpy() for t in panel.potrf_inv_plain(
            wrel, torch.tensor(D[None], dtype=getattr(torch, dtype))))
        assert (np.diag(L).imag == 0).all()
        assert (np.triu(L, 1) == 0).all() and (np.triu(Li, 1) == 0).all()
        assert (L[pad] == 0).all() and (L[:, pad] == 0).all()
        np.testing.assert_array_equal(Li[pad], np.eye(nb)[pad])
        assert (Li[~pad][:, pad] == 0).all()
        if w == 0:
            assert (L == 0).all()
            np.testing.assert_array_equal(Li, np.eye(nb))
        H = np.tril(D[:w, :w]) + np.tril(D[:w, :w], -1).conj().T
        lw = L[:w, :w].astype(np.complex128)
        assert np.abs(lw @ lw.conj().T - H).max(initial=0) <= TOL[dtype] \
            * max(1.0, np.abs(H).max(initial=0))
        eye = Li.astype(np.complex128) @ (L + np.diag(pad.astype(L.dtype)))
        assert np.abs(eye - np.eye(nb)).max() <= TOL[dtype] * max(
            1.0, np.abs(Li).max())


@pytest.mark.parametrize("scale", [2.0 ** 60, 2.0 ** -60],
                         ids=["2^60", "2^-60"])
@pytest.mark.parametrize("w", [1, 9, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_diag_blocks_match_lax_scaled(dtype, w, scale):
    """The plain diagonal blocks on blocks scaled by 2^60 and 2^-60, where
    the square of a complex64 pivot's modulus (2^+-120 times the block's
    spread) leaves the type's range, against lax.linalg on the same blocks:
    each output within the tolerance of its own largest entry."""
    rng = np.random.default_rng(60 + w)
    nb = 32
    X = rng.standard_normal((nb, nb)) + 1j * rng.standard_normal((nb, nb))
    H = X @ X.conj().T + nb * np.eye(nb)
    Dp = (np.tril(H) + np.triu(np.full((nb, nb), 1e3 + 1e3j), 1)) * scale
    Du = (rng.standard_normal((nb, nb)) + 1j * rng.standard_normal((nb, nb)))
    Du = (Du + np.diag(np.abs(Du).sum(1) + 1)) * scale
    wrel = torch.tensor([w], dtype=torch.int32)
    td = getattr(torch, dtype)
    for plain, ref, D in ((panel.potrf_inv_plain, _jax_potrf_inv, Dp),
                          (panel.getrf_inv_plain, _jax_getrf_inv, Du)):
        got = plain(wrel, torch.tensor(D[None], dtype=td))
        want = ref(w, D.astype(dtype))
        for g, r in zip(got, want):
            g = g[0].numpy()
            assert np.isfinite(g).all()
            assert np.abs(g - r).max() <= TOL[dtype] * np.abs(r).max()


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_interop_and_checkpoints(tmp_path, lu):
    """A JAX complex factor carried into the port solves there; a port
    factor saved loads in the JAX package and the reverse, slot for slot."""
    A = generate.random_unsym_complex(60, density=0.08, seed=30) if lu \
        else generate.random_hermitian(50, density=0.08, seed=20)
    cfg = dict(dtype="complex128", ordering="nd")
    jk = spfx.LU if lu else spfx.Cholesky
    tk = spfx_torch.LU if lu else spfx_torch.Cholesky
    jf = jk(A, spfx.Config(**cfg)).factorize(A)
    ctx = tk(A, Config(**cfg), device="cpu")
    arrays = [np.asarray(getattr(jf, nm)) for nm in _names(lu)]
    tf = (lu_factor_from_numpy if lu else factor_from_numpy)(ctx, *arrays)
    b = _rhs(A.shape[0], 3)
    assert spfx_torch.scaled_residual(A, tf.solve(b), b) <= 1e-12
    pj, pt = tmp_path / "jax.npz", tmp_path / "torch.npz"
    jcheckpoint.save_factor(pj, jf)
    checkpoint.save_factor(pt, tf)
    g = checkpoint.load_factor(pj, config=Config(**cfg), device="cpu")
    h = jcheckpoint.load_factor(pt, config=spfx.Config(**cfg))
    for nm, a in zip(_names(lu), arrays):
        assert getattr(g, nm).dtype == torch.complex128
        assert np.array_equal(getattr(g, nm).numpy(), a)
        assert np.array_equal(np.asarray(getattr(h, nm)), a)
    assert spfx_torch.scaled_residual(A, g.solve(b), b) <= 1e-12


def test_cli_complex(tmp_path, capsys):
    """The CLI on complex .mtx files: a Hermitian one through the Cholesky
    engine, an unsymmetric one through auto (LU), complex64, each with a
    complex right-hand side and its factor saved."""
    herm = tmp_path / "herm.mtx"
    matrix_market.write_matrix(str(herm), generate.random_hermitian(
        50, density=0.08, seed=21), symmetric=True)
    uns = tmp_path / "unsym.mtx"
    matrix_market.write_matrix(str(uns), generate.random_unsym_complex(
        60, density=0.08, seed=30))
    rc = cli.main([str(herm), "--engine", "chol", "--dtype", "complex64",
                   "--device", "cpu", "--save-factor", str(tmp_path)])
    rc2 = cli.main([str(uns), "--dtype", "complex64", "--device", "cpu",
                    "--save-factor", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and rc2 == 0
    assert "engine=chol dtype=complex64" in out
    assert "engine=lu dtype=complex64" in out
    assert out.count("residual") == 2
    f = checkpoint.load_factor(tmp_path / "herm.mtx.factor.npz",
                               device="cpu")
    assert f.L.dtype == torch.complex64


def test_complex_kernel_views():
    """What the kernels are handed for complex tensors: an extend-add slab
    as the real rows of 2 csp values it is in memory (complex64 with odd
    csp then takes the single-value path: 8 csp bytes is no multiple of
    16), and a gather window aligned down to ALIGN complex values."""
    from spfx_torch.kernels import extend_add, gather
    from spfx_torch.plan.schedule import ALIGN
    s = torch.zeros(4, 33, dtype=torch.complex64)
    r = extend_add._real(s)
    assert r.shape == (4, 66) and r.dtype == torch.float32
    assert r.data_ptr() == s.data_ptr()
    assert not extend_add.vector_path(r.shape[1], r.element_size(), [0])
    for dt, csp in ((torch.complex64, 32), (torch.complex128, 33)):
        r = extend_add._real(torch.zeros(4, csp, dtype=dt))
        assert extend_add.vector_path(r.shape[1], r.element_size(), [0])
    L = torch.arange(4 * ALIGN, dtype=torch.float64).to(torch.complex128)
    starts = torch.tensor([ALIGN + ALIGN // 2 + 3, -1], dtype=torch.int32)
    got = gather.window_gather(L, starts, ALIGN)
    assert torch.equal(got[0], L[ALIGN:2 * ALIGN])
    assert not got[1].any()
