"""The port's SPFX_PANEL_KERNEL panel routes on the CPU against the JAX
package, with the same seeded numpy inputs: the four whole-panel functions
(plain PyTorch versions here) against the Pallas kernels in interpret mode,
the route table against ``vmem.route_panel``, and whole Cholesky and LU
factorizations under each route against ``spfx.Cholesky`` / ``spfx.LU``."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

import spfx
from spfx.kernels import pallas_blocks, vmem

import spfx_torch
from spfx_torch import Config
from spfx_torch.io import generate
from spfx_torch.kernels import panel, panel_lanes, panel_wide, route
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


# --------------------------------------------------------------------------
# the four whole-panel functions against the Pallas kernels
# --------------------------------------------------------------------------

def _counts(rng, B, cp, rbp):
    """Partial widths and nbelow: task 0 is full when B > 1, every other
    task (and the only one when B = 1) partial."""
    w = rng.integers(1, cp + 1, B).astype(np.int32)
    nb = rng.integers(0, rbp + 1, B).astype(np.int32)
    if B > 1:
        w[0], nb[0] = cp, rbp
    else:
        w[0], nb[0] = cp - 3, max(rbp - 7, 0)
    return w, nb


def _chol_inputs(B, cp, rbp, dtype, seed):
    """SPD diagonal windows with junk above the diagonal, random below
    blocks (task-major)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, cp, cp))
    D = X @ np.swapaxes(X, 1, 2) + cp * np.eye(cp)[None]
    D = np.tril(D) + np.triu(np.full((cp, cp), 7.0), 1)[None]
    Bm = rng.standard_normal((B, rbp, cp))
    w, nb = _counts(rng, B, cp, rbp)
    return w, nb, D.astype(dtype), Bm.astype(dtype)


def _lu_inputs(B, cp, rbp, dtype, seed):
    """Diagonally dominant unsymmetric fronts stored as DL (lower) and DU
    (U^T strictly lower), with junk where neither side is read."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, cp, cp))
    A += (np.abs(A).sum(axis=2)[..., None] + 1.0) * np.eye(cp)[None]
    junk = np.triu(np.full((cp, cp), 5.0), 1)[None]
    DL = np.tril(A) + junk
    DU = np.tril(np.swapaxes(A, 1, 2), -1) + junk + 3.0 * np.eye(cp)[None]
    BL = rng.standard_normal((B, rbp, cp))
    BU = rng.standard_normal((B, rbp, cp))
    w, nb = _counts(rng, B, cp, rbp)
    return (w, nb) + tuple(a.astype(dtype) for a in (DL, DU, BL, BU))


def _lanes_np(a):
    return np.ascontiguousarray(np.transpose(a, (1, 2, 0)))


def _run(fn_name, w, nb, blocks, cp, rbp, dtype):
    """(JAX outputs, port outputs) of one function, as numpy arrays in the
    function's own layout."""
    lanes = fn_name.endswith("lanes")
    if lanes:
        blocks = [_lanes_np(a) for a in blocks]
    jout = getattr(pallas_blocks, fn_name)(
        jnp.asarray(w), jnp.asarray(nb), *(jnp.asarray(a) for a in blocks),
        cp=cp, rbp=rbp)
    mod = panel_lanes if lanes else panel_wide
    tout = getattr(mod, fn_name)(
        torch.from_numpy(w), torch.from_numpy(nb),
        *(torch.from_numpy(a) for a in blocks), cp, rbp)
    return [np.asarray(a) for a in jout], [t.numpy() for t in tout]


FUNCS = ["chol_panel_deltas_lanes", "lu_panel_deltas_lanes",
         "chol_panel_deltas_wide", "lu_panel_deltas_wide"]
# cp 64 runs two 32-column panels in the wide kernels
SHAPES = [(32, 0, 8), (32, 64, 1), (64, 0, 1), (64, 64, 8)]


@pytest.mark.parametrize("cp,rbp,B", SHAPES,
                         ids=[f"cp{c}-rbp{r}-B{b}" for c, r, b in SHAPES])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn_name", FUNCS)
def test_panel_deltas_match_pallas(fn_name, dtype, cp, rbp, B):
    """f64: <= 1e-10 absolute (Cholesky), <= 1e-8 (LU), the bounds
    tests/test_panel_kernels.py holds these kernels to. f32: <= 1e-4 of the
    output's largest entry, because the sums are rounded in another
    order."""
    npd = DTYPES[dtype][0]
    lu = fn_name.startswith("lu")
    seed = 100 + 10 * SHAPES.index((cp, rbp, B)) + lu
    ins = (_lu_inputs if lu else _chol_inputs)(B, cp, rbp, npd, seed)
    w, nb, blocks = ins[0], ins[1], ins[2:]
    ref, got = _run(fn_name, w, nb, blocks, cp, rbp, dtype)
    assert len(got) == (4 if lu else 2)
    for r, g in zip(ref, got):
        assert g.shape == r.shape and g.dtype == r.dtype
        if not r.size:
            continue
        if dtype == "float64":
            assert np.abs(g - r).max() <= (1e-8 if lu else 1e-10)
        else:
            assert np.abs(g - r).max() <= 1e-4 * max(np.abs(r).max(), 1.0)


# both families' 32-column blocks and 32-row tiles: a masked last block,
# one row past a tile (or one short of it), several 32-column blocks with
# B > 1. The shapes follow what the JAX kernels write in full: the lanes
# ones run B // lanes_slab(B) grid steps, so B is a power of two there;
# the wide ones run rbp // wide_row_blk(...) row steps and leave the rows
# past the last full step unwritten (NaN in interpret mode at (32, 40, 1)
# and (96, 70, 2), where the port's rows are right), so the wide shapes
# are ones where every row is written.
BLOCK_SHAPES = {"lanes": [(96, 70, 2), (160, 33, 1), (256, 40, 4)],
                "wide": [(96, 64, 2), (160, 31, 1), (256, 128, 3)]}
BLOCK_CASES = [(fam, cp, rbp, B) for fam, shapes in BLOCK_SHAPES.items()
               for cp, rbp, B in shapes]


@pytest.mark.parametrize("family,cp,rbp,B", BLOCK_CASES,
                         ids=[f"{f}-cp{c}-rbp{r}-B{b}"
                              for f, c, r, b in BLOCK_CASES])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["chol", "lu"])
def test_panel_deltas_blocks_match_pallas(kind, dtype, family, cp, rbp, B):
    """chol_ and lu_panel_deltas_{lanes,wide} at shapes that cross the
    kernels' 32-column blocks and 32-row tiles, with the tolerances of
    test_panel_deltas_match_pallas. On the CPU the port runs its plain
    versions, which chip_smoke.py holds the card's kernels to."""
    lu = kind == "lu"
    seed = (200 if family == "lanes" else 300) \
        + 10 * BLOCK_SHAPES[family].index((cp, rbp, B)) + lu
    ins = (_lu_inputs if lu else _chol_inputs)(B, cp, rbp, DTYPES[dtype][0],
                                               seed)
    ref, got = _run(f"{kind}_panel_deltas_{family}", ins[0], ins[1],
                    ins[2:], cp, rbp, dtype)
    assert len(got) == (4 if lu else 2)
    for r, g in zip(ref, got):
        assert g.shape == r.shape and g.dtype == r.dtype
        if dtype == "float64":
            assert np.abs(g - r).max() <= (1e-8 if lu else 1e-10)
        else:
            assert np.abs(g - r).max() <= 1e-4 * max(np.abs(r).max(), 1.0)


@pytest.mark.parametrize("lanes", [True, False], ids=["lanes", "wide"])
def test_panel_deltas_zero_off_the_live_part(lanes):
    """Padding rows and columns, and below rows >= nbelow, get exact zero
    deltas; a task with width 0 gets zero deltas everywhere."""
    B, cp, rbp = 3, 32, 16
    w, nb, D, Bm = _chol_inputs(B, cp, rbp, np.float64, 7)
    w[:] = [cp, 9, 0]
    nb[:] = [rbp, 4, rbp]
    if lanes:
        dd, db = (np.transpose(t.numpy(), (2, 0, 1)) for t in
                  panel_lanes.chol_panel_deltas_lanes(
                      torch.from_numpy(w), torch.from_numpy(nb),
                      torch.from_numpy(_lanes_np(D)),
                      torch.from_numpy(_lanes_np(Bm)), cp, rbp))
    else:
        dd, db = (t.numpy() for t in panel_wide.chol_panel_deltas_wide(
            torch.from_numpy(w), torch.from_numpy(nb), torch.from_numpy(D),
            torch.from_numpy(Bm), cp, rbp))
    assert not dd[1, 9:].any() and not dd[1, :, 9:].any()
    assert not db[1, 4:].any() and not db[1, :, 9:].any()
    assert not dd[2].any() and not db[2].any()
    # above the diagonal of the live block the delta clears the junk
    np.testing.assert_array_equal(dd[0][np.triu_indices(cp, 1)],
                                  -D[0][np.triu_indices(cp, 1)])


@pytest.mark.parametrize("bad,match", [
    (dict(cp=257), "cp must be"),
    (dict(dtype=torch.float16), "float32 or float64"),
    (dict(widths_dtype=torch.int64), "int32"),
    (dict(below_rows=8), "shape"),
    (dict(noncontig=True), "contiguous"),
])
@pytest.mark.parametrize("lanes", [True, False], ids=["lanes", "wide"])
def test_panel_deltas_reject_bad_input(lanes, bad, match):
    cp = bad.get("cp", 32)
    B, rbp = 2, 16
    dt = bad.get("dtype", torch.float64)
    w = torch.full((B,), min(cp, 32), dtype=bad.get("widths_dtype",
                                                   torch.int32))
    nb = torch.zeros(B, dtype=torch.int32)
    D = torch.zeros((B, cp, cp), dtype=dt)
    Bm = torch.zeros((B, bad.get("below_rows", rbp), cp), dtype=dt)
    if bad.get("noncontig"):
        D = torch.zeros((B, cp, 2 * cp), dtype=dt)[:, :, ::2]
    if lanes:
        D, Bm = D.permute(1, 2, 0), Bm.permute(1, 2, 0)
        if not bad.get("noncontig"):
            D, Bm = D.contiguous(), Bm.contiguous()
        fn = panel_lanes.chol_panel_deltas_lanes
    else:
        fn = panel_wide.chol_panel_deltas_wide
    with pytest.raises((ValueError, TypeError), match=match):
        fn(w, nb, D, Bm, cp, rbp)


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------

MODES = [None, "auto", "blocked", "lanes", "wide", "mixed"]


def _set_mode(monkeypatch, mode):
    monkeypatch.delenv("SPFX_NO_PALLAS", raising=False)
    if mode is None:
        monkeypatch.delenv(route.ENV, raising=False)
    else:
        monkeypatch.setenv(route.ENV, mode)


@pytest.mark.parametrize("mode", MODES, ids=[str(m) for m in MODES])
def test_route_table_matches_vmem(monkeypatch, mode):
    """Over a grid of classes: the JAX route's answer, except where its
    VMEM byte model alone refuses a class with cp <= 256 (the port takes
    the kernel) and where it answers 'xla' for cp > 256 (the port takes
    'blocked')."""
    _set_mode(monkeypatch, mode)
    model_refusals = 0
    for cp in (32, 64, 128, 256, 512):
        for rbp in (0, 64, 512, 2560):
            for B in (1, 16, 256):
                for itemsize in (4, 8):
                    for lu in (False, True):
                        jr = vmem.route_panel(cp, rbp, B, itemsize, lu)
                        pr = route.route_panel(cp, rbp, B, itemsize, lu)
                        if cp > 256:
                            assert pr == "blocked"
                            assert jr in ("blocked", "xla")
                        elif pr != jr:
                            fam = "wide" if mode == "wide" else "lanes"
                            nbytes = getattr(vmem, f"{fam}_panel_bytes")(
                                cp, rbp, B, itemsize, lu)
                            assert nbytes > vmem.CAP_ROUTE
                            assert pr == fam and jr in ("blocked", "xla")
                            model_refusals += 1
    # the wide model never refuses a class of this grid (its footprint is
    # one task's); the lanes model refuses the tall and many-task ones
    assert (model_refusals > 0) == (mode in ("lanes", "mixed"))


def test_route_takes_the_class_the_vmem_model_refuses(monkeypatch):
    """The recorded difference: the (128, 512, 16) f32 lanes class overflows
    the TPU's scoped VMEM (tests/test_vmem_model.py), so JAX routes it to
    XLA; the port has no such limit and takes the lanes kernel."""
    _set_mode(monkeypatch, "lanes")
    assert vmem.route_panel(128, 512, 16, 4) == "xla"
    assert route.route_panel(128, 512, 16, 4) == "lanes"
    _set_mode(monkeypatch, "mixed")
    assert vmem.route_panel(128, 512, 16, 4) == "blocked"
    assert route.route_panel(128, 512, 16, 4) == "lanes"


def test_route_rejects_unknown_mode(monkeypatch):
    _set_mode(monkeypatch, "lane")
    with pytest.raises(ValueError, match="SPFX_PANEL_KERNEL"):
        route.panel_mode()
    with pytest.raises(ValueError, match="lanes"):
        route.route_panel(32, 0, 1)
    with pytest.raises(ValueError, match="SPFX_PANEL_KERNEL"):
        spfx_torch.cholesky(generate.laplacian_3d(3),
                            Config(dtype="float64"), device="cpu")
    with pytest.raises(ValueError, match="panel mode"):
        route.route_panel(32, 0, 1, mode="xla")


# --------------------------------------------------------------------------
# whole factorizations under each route
# --------------------------------------------------------------------------

def _spies(monkeypatch):
    """Count the calls of each panel-kernel entry the routers reach."""
    calls = {}
    for mod, names in ((panel_lanes, ("chol_panel_deltas_lanes",
                                      "lu_panel_deltas_lanes")),
                       (panel_wide, ("chol_panel_deltas_wide",
                                     "lu_panel_deltas_wide")),
                       (panel, ("potrf_inv", "getrf_inv"))):
        for name in names:
            fn = getattr(mod, name)
            calls[name] = 0

            def spy(*a, _fn=fn, _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, spy)
    return calls


def _expected_calls(plan, mode, lu):
    """The calls each entry gets from one factorization under ``mode``."""
    kind = "lu" if lu else "chol"
    want = {f"{kind}_panel_deltas_lanes": 0, f"{kind}_panel_deltas_wide": 0,
            "getrf_inv" if lu else "potrf_inv": 0}
    for lp in plan.levels:
        for pb in lp.panels:
            r = route.route_panel(pb.cp, pb.rbp, len(pb.widths), 8, lu,
                                  mode=mode)
            if r == "blocked":
                want["getrf_inv" if lu else "potrf_inv"] += -(-pb.cp // 32)
            else:
                want[f"{kind}_panel_deltas_{r}"] += 1
    return want


ROUTE_MODES = ["lanes", "wide", "mixed"]


@pytest.fixture(scope="module")
def chol_ref():
    A = generate.laplacian_3d(6)
    return A, spfx.Cholesky(A, spfx.Config(dtype="float64")).factorize(A)


@pytest.mark.parametrize("mode", ROUTE_MODES + [None],
                         ids=ROUTE_MODES + ["unset"])
def test_cholesky_under_route_matches_jax(monkeypatch, chol_ref, mode):
    """laplacian_3d(6), f64 (panel classes (32, 32), (64, 32), (128, 0)):
    every PC step goes through the route's entry, the flat factor is within
    1e-12 of the JAX factor's max, the refined residual <= 1e-12."""
    A, jf = chol_ref
    _set_mode(monkeypatch, mode)
    calls = _spies(monkeypatch)
    ctx = spfx_torch.Cholesky(A, Config(dtype="float64"), device="cpu")
    f = ctx.factorize(A)
    want = _expected_calls(ctx.plan, route.panel_mode(), lu=False)
    assert {k: calls[k] for k in want} == want
    if mode is not None:
        assert want["potrf_inv"] == 0
    Lj = np.asarray(jf.L)
    assert np.abs(f.L.numpy() - Lj).max() <= 1e-12 * np.abs(Lj).max()
    b = spfx_torch.synth_rhs(A)
    assert spfx_torch.scaled_residual(A, f.solve(b), b) <= 1e-12


LU_MATRICES = {
    "lap6": lambda: generate.laplacian_3d(6),
    # the five CASES of tests/test_lu.py
    "unsym50": lambda: generate.random_unsym(50, density=0.08, seed=10),
    "unsym70": lambda: generate.random_unsym(70, density=0.05, seed=11),
    "sympat60": lambda: generate.random_unsym(60, density=0.1, seed=12,
                                              symmetric_pattern=True),
    "lap2d9": lambda: generate.laplacian_2d(9),
    "diag12": lambda: sp.csc_matrix(sp.diags(np.arange(1.0, 13.0))),
}


@pytest.fixture(scope="module")
def lu_refs():
    """JAX LU factors of every matrix, computed once."""
    out = {}
    for name, make in LU_MATRICES.items():
        A = make()
        cfg = spfx.Config(dtype="float64", ordering="nd")
        out[name] = (A, spfx.LU(A, cfg).factorize(A))
    return out


@pytest.mark.parametrize("name", list(LU_MATRICES))
@pytest.mark.parametrize("mode", ROUTE_MODES)
def test_lu_under_route_matches_jax(monkeypatch, lu_refs, mode, name):
    """f64: every PC step through the route's entry, both flat factors
    within 1e-12 of the JAX factor's max, refined residual <= 1e-12."""
    A, jf = lu_refs[name]
    _set_mode(monkeypatch, mode)
    calls = _spies(monkeypatch)
    ctx = spfx_torch.LU(A, Config(dtype="float64", ordering="nd"),
                        device="cpu")
    f = ctx.factorize(A)
    want = _expected_calls(ctx.plan, mode, lu=True)
    assert {k: calls[k] for k in want} == want
    assert want["getrf_inv"] == 0
    for ref, got in ((jf.Lx, f.Lx), (jf.Ux, f.Ux)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    b = spfx_torch.synth_rhs(A)
    assert spfx_torch.scaled_residual(A, f.solve(b), b) <= 1e-12


def test_panel_routes_agree_in_place():
    """factor_panels_chol_u / factor_panels_lu_u under each mode change the
    same slots of the flat arrays as the blocked path, to rounding (f64)."""
    from spfx_torch.kernels import blocks
    A = generate.laplacian_3d(5)
    ctx = spfx_torch.LU(A, Config(dtype="float64"), device="cpu")
    plan = ctx.plan
    rng = np.random.default_rng(3)
    L0 = torch.from_numpy(rng.standard_normal(plan.storage))
    pbs = [pb for lp in plan.levels for pb in lp.panels]
    pb = max(pbs, key=lambda p: p.cp * (p.cp + p.rbp))
    widths, nbelow, _ = pb.to_u("cpu")
    lo = int(pb.slab_lo[0])
    res = {}
    for mode in ["blocked"] + ROUTE_MODES:
        Lx, Ux = L0.clone(), L0.clone() * 0.5
        # make the diagonal windows dominant so the no-pivot LU and the
        # Cholesky of the lower triangle are defined
        blk = Lx[lo:lo + len(widths) * (pb.cp + pb.rbp) * pb.cp].view(
            len(widths), pb.cp + pb.rbp, pb.cp)
        blk[:, :pb.cp, :] += 4.0 * pb.cp * torch.eye(pb.cp,
                                                     dtype=torch.float64)
        L = Lx.clone()
        blocks.factor_panels_chol_u(L, widths, nbelow, lo, pb.cp, pb.rbp,
                                    mode=mode)
        blocks.factor_panels_lu_u(Lx, Ux, widths, nbelow, lo, pb.cp, pb.rbp,
                                  mode=mode)
        res[mode] = (L, Lx, Ux)
    for mode in ROUTE_MODES:
        for a, b in zip(res[mode], res["blocked"]):
            assert torch.allclose(a, b, rtol=0, atol=1e-12 * b.abs().max())
