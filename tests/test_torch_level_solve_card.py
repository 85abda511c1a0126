"""The level-solve kernel (spfx_torch/kernels/csrc/level_solve.cu) on the
card against the torch chain it replaces: bucket by bucket and on whole
unrefined solves at 48^3 (Cholesky and LU in float32, Cholesky in
float64), float32 within 1e-5 and float64 within 1e-12 of the chain's
result relative to its largest entry; LU with a static pivot, the fused
engine (rowwin: every step on the chain) and a subtree engine; buckets
wider than CP_SHARED (y in the kernel's global workspace), one built by
hand and the top of a plan whose supernodes reach 2,048 columns. Each test
carries the ``card`` marker and skips without a CUDA device; run them on
the card with ``python -m pytest tests/test_torch_level_solve_card.py -m
card``. No JAX here: the chain is the reference."""

import functools

import numpy as np
import pytest
import torch

import spfx_torch
from spfx_torch import Config
from spfx_torch.bench.kernel_probe import unsym_laplacian
from spfx_torch.io import generate
from spfx_torch.kernels import _cuda, blocks, level_solve

TOL = {"float32": 1e-5, "float64": 1e-12}
GRID = 48
SETS = [("chol", "float32"), ("lu", "float32"), ("chol", "float64")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card)")


@functools.lru_cache(maxsize=None)
def _factor(kind: str, dtype: str):
    """(A, context, factor) at GRID on the card, device solves."""
    lu = kind == "lu"
    A = unsym_laplacian(GRID) if lu else generate.laplacian_3d(GRID)
    ctx = (spfx_torch.LU if lu else spfx_torch.Cholesky)(
        A, Config(dtype=dtype, solve_backend="device"), device="cuda")
    return A, ctx, ctx.factorize(A)


@pytest.fixture
def chain(monkeypatch):
    """A switch that sends every bucket step to the chain while on."""
    takes = level_solve.takes

    def set_chain(on: bool):
        monkeypatch.setattr(level_solve, "takes",
                            (lambda F, pb: False) if on else takes)
    yield set_chain
    monkeypatch.setattr(level_solve, "takes", takes)


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.card
@pytest.mark.parametrize("kind,dtype", SETS,
                         ids=[f"{k}-{d}" for k, d in SETS])
def test_kernel_matches_chain_bucket_by_bucket(kind, dtype):
    """Every PC bucket forward in level order, then backward in reverse,
    at nrhs 1, 16 and 20 (a partial group of right-hand sides): the
    kernel's x within TOL of the chain's on the same input, and the
    sentinel row untouched."""
    _card()
    A, ctx, f = _factor(kind, dtype)
    lu = kind == "lu"
    F, G = (f.Lx, f.Ux) if lu else (f.L, f.L)
    pbs = [pb for lp in ctx.plan.levels for pb in lp.panels]
    assert all(level_solve.takes(F, pb) for pb in pbs)
    n = A.shape[0]
    for nrhs in (1, 16, 20):
        gen = torch.Generator().manual_seed(nrhs)
        x = torch.randn((n + 1, nrhs), generator=gen,
                        dtype=F.dtype).cuda()
        x[n] = 0
        for fwd, Fk, order in ((True, F, pbs), (False, G, pbs[::-1])):
            for pb in order:
                tabs = pb.to(Fk.device)
                xk, xc = x.clone(), x.clone()
                if fwd:
                    level_solve.level_solve_fwd(Fk, xk, *tabs, cp=pb.cp,
                                                rbp=pb.rbp, unit=lu)
                    blocks.solve_fwd_level_c(Fk, xc, *tabs, cp=pb.cp,
                                             rbp=pb.rbp, lu=lu)
                else:
                    level_solve.level_solve_bwd(Fk, xk, *tabs, cp=pb.cp,
                                                rbp=pb.rbp)
                    blocks.solve_bwd_level_c(Fk, xc, *tabs, cp=pb.cp,
                                             rbp=pb.rbp, lu=lu)
                assert _rel(xk[:n].cpu().numpy(), xc[:n].cpu().numpy()) \
                    <= TOL[dtype], (fwd, pb.cp, pb.rbp, len(pb.widths))
                assert float(xk[n].abs().max()) == 0.0
                x = xc


@pytest.mark.card
@pytest.mark.parametrize("kind,dtype", SETS,
                         ids=[f"{k}-{d}" for k, d in SETS])
def test_whole_solve_matches_chain(kind, dtype, chain):
    """One unrefined device solve through the kernel's graph against the
    chain's, 16 right-hand sides; the graph counts its bucket steps: all
    on the kernel, one launch each; the refined solve reaches 1e-12."""
    _card()
    A, ctx, f = _factor(kind, dtype)
    B = np.random.default_rng(3).standard_normal((A.shape[0], 16))
    f._solve_graphs.clear()
    xk = f.solve(B, refine=0)
    cap = ctx._solver.captures[16]
    steps = 2 * sum(len(lp.panels) for lp in ctx.plan.levels)
    assert cap["steps"] == {"kernel": steps, "chain": 0}
    assert cap["launches"]["level_solve"] == steps
    chain(True)
    f._solve_graphs.clear()
    xc = f.solve(B, refine=0)
    assert ctx._solver.captures[16]["steps"] == {"kernel": 0,
                                                 "chain": steps}
    assert ctx._solver.captures[16]["launches"]["level_solve"] == 0
    chain(False)
    f._solve_graphs.clear()
    assert _rel(xk, xc) <= TOL[dtype]
    b = B[:, 0]
    assert spfx_torch.scaled_residual(A, f.solve(b), b) <= 1e-12


@pytest.mark.card
def test_static_pivot_lu(chain):
    """LU with the static pivot solves through the kernel on the card as
    the chain does, and refines to 1e-12."""
    _card()
    A = generate.random_unsym(400, density=0.02, seed=12)
    A = A[np.random.default_rng(1).permutation(400)].tocsc()
    f = spfx_torch.lu(A, Config(dtype="float64", static_pivot=True,
                                solve_backend="device"), device="cuda")
    assert f.row_perm is not None
    b = spfx_torch.synth_rhs(A)
    xk = f.solve(b, refine=0)
    chain(True)
    f._solve_graphs.clear()
    xc = f.solve(b, refine=0)
    chain(False)
    f._solve_graphs.clear()
    assert _rel(xk, xc) <= TOL["float64"]
    assert spfx_torch.scaled_residual(A, f.solve(b), b) <= 1e-12


@pytest.mark.card
@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_fused_engine_keeps_the_chain(lu):
    """The fused engine (rowwin buckets) solves through the chain: no
    level_solve launch, and its solve is the kernel path's on the same
    matrix within float64's TOL."""
    _card()
    A = unsym_laplacian(16) if lu else generate.laplacian_3d(16)
    kind = spfx_torch.LU if lu else spfx_torch.Cholesky
    cfg = dict(dtype="float64", solve_backend="device")
    ff = kind(A, Config(layout="rowwin", fused=True, **cfg),
              device="cuda").factorize(A)
    fm = kind(A, Config(**cfg), device="cuda").factorize(A)
    b = spfx_torch.synth_rhs(A)
    _cuda.reset_launch_counts()
    xf = ff.solve(b, refine=0)
    assert _cuda.launch_counts()["level_solve"] == 0
    xm = fm.solve(b, refine=0)
    assert _cuda.launch_counts()["level_solve"] > 0
    assert _rel(xf, xm) <= TOL["float64"]


@pytest.mark.card
@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_subtree_engine(lu, chain):
    """A subtree engine's factor (a mesh of this process alone) solves
    through the kernel as the chain does, and refines to 1e-12."""
    _card()
    from spfx_torch.dist.mesh import make_mesh
    from spfx_torch.dist.subtree import SubtreeCholesky, SubtreeLU
    A = unsym_laplacian(16) if lu else generate.laplacian_3d(16)
    kind = SubtreeLU if lu else SubtreeCholesky
    st = kind(A, Config(dtype="float64", solve_backend="device"),
              mesh=make_mesh("d"))
    f = st.factorize(A)
    b = spfx_torch.synth_rhs(A)
    _cuda.reset_launch_counts()
    xk = f.solve(b, refine=0)
    assert _cuda.launch_counts()["level_solve"] > 0
    chain(True)
    f._solve_graphs.clear()
    xc = f.solve(b, refine=0)
    chain(False)
    f._solve_graphs.clear()
    assert _rel(xk, xc) <= TOL["float64"]
    assert spfx_torch.scaled_residual(A, f.solve(b), b) <= 1e-12


def _wide_bucket(dtype, rbp: int, seed: int = 9):
    """(F, tables, cp, rbp, n) of a bucket wider than CP_SHARED on the
    card: a live task with dead columns (and, where rbp allows, dead rows)
    and a -1 among its live columns and rows, then a pad task."""
    rng = np.random.default_rng(seed)
    cp = level_solve.CP_SHARED + 40
    w, nb, n = cp - 14, max(0, rbp - 20), 3000
    L11 = (np.tril(rng.standard_normal((cp, cp))) * 0.5 / np.sqrt(cp)
           + 2.0 * np.eye(cp))
    L21 = rng.standard_normal((rbp, cp)) / np.sqrt(cp)
    blk = np.concatenate([L11.ravel(), L21.ravel()])
    F = torch.from_numpy(np.concatenate([blk, blk]).astype(dtype)).cuda()
    perm = rng.permutation(n)
    xcols = np.full((2, cp), -1, np.int32)
    xrows = np.full((2, rbp), -1, np.int32)
    xcols[0, :w] = perm[:w]
    xcols[0, 5] = -1
    xrows[0, :nb] = perm[w:w + nb]
    if nb > 17:
        xrows[0, 17] = -1
    tabs = [torch.tensor(a, dtype=torch.int32) for a in (
        [w, cp], [nb, rbp], [0, -1], [cp * cp, -1])] + [
        torch.from_numpy(xcols), torch.from_numpy(xrows)]
    return F, [t.cuda() for t in tabs], cp, rbp, n


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rbp", [0, 200, 700], ids=["rbp0", "rbp200",
                                                    "rbp700"])
def test_wide_bucket_matches_plain_and_chain(dtype, rbp):
    """A bucket wider than CP_SHARED, with no rows below, one tile of them
    and three: both sweeps (unit and not) at nrhs 1, 16 and 20, the
    kernel within TOL of the plain version and of the chain, the sentinel
    row untouched."""
    _card()
    F, tabs, cp, rbp, n = _wide_bucket(dtype, rbp)
    assert not level_solve._y_shared(cp)
    for nrhs in (1, 16, 20):
        gen = torch.Generator().manual_seed(nrhs)
        x0 = torch.randn((n + 1, nrhs), generator=gen,
                         dtype=F.dtype).cuda()
        x0[n] = 0
        for fwd, unit in ((True, False), (True, True), (False, False)):
            xk, xp, xc = x0.clone(), x0.clone(), x0.clone()
            _cuda.reset_launch_counts()
            if fwd:
                level_solve.level_solve_fwd(F, xk, *tabs, cp=cp, rbp=rbp,
                                            unit=unit)
                level_solve.level_solve_fwd_plain(F, xp, *tabs, cp=cp,
                                                  rbp=rbp, unit=unit)
                blocks.solve_fwd_level_c(F, xc, *tabs, cp=cp, rbp=rbp,
                                         lu=unit)
            else:
                level_solve.level_solve_bwd(F, xk, *tabs, cp=cp, rbp=rbp)
                level_solve.level_solve_bwd_plain(F, xp, *tabs, cp=cp,
                                                  rbp=rbp)
                blocks.solve_bwd_level_c(F, xc, *tabs, cp=cp, rbp=rbp)
            assert _cuda.launch_counts()["level_solve"] == 1
            for want in (xp, xc):
                assert _rel(xk[:n].cpu().numpy(), want[:n].cpu().numpy()) \
                    <= TOL[dtype], (nrhs, fwd, unit)
            assert float(xk[n].abs().max()) == 0.0


WIDE_GRID = 34      # the top separator, 34^2 = 1,156 columns: cp 2,048


@pytest.mark.card
@pytest.mark.parametrize("kind,dtype", [("chol", "float64"),
                                        ("lu", "float32")],
                         ids=["chol-float64", "lu-float32"])
def test_wide_supernodes_solve_through_the_kernel(kind, dtype, chain):
    """Config(max_sn_cols=2048) at 34^3: the plan's top buckets are wider
    than CP_SHARED, and every bucket step of the device solve still takes
    the kernel (one launch each); the unrefined solve within TOL of the
    chain's, the refined one to 1e-12."""
    _card()
    lu = kind == "lu"
    A = unsym_laplacian(WIDE_GRID) if lu \
        else generate.laplacian_3d(WIDE_GRID)
    ctx = (spfx_torch.LU if lu else spfx_torch.Cholesky)(
        A, Config(dtype=dtype, solve_backend="device", max_sn_cols=2048),
        device="cuda")
    f = ctx.factorize(A)
    pbs = [pb for lp in ctx.plan.levels for pb in lp.panels]
    assert max(pb.cp for pb in pbs) > level_solve.CP_SHARED
    B = np.random.default_rng(4).standard_normal((A.shape[0], 16))
    xk = f.solve(B, refine=0)
    cap = ctx._solver.captures[16]
    assert cap["steps"] == {"kernel": 2 * len(pbs), "chain": 0}
    assert cap["launches"]["level_solve"] == 2 * len(pbs)
    chain(True)
    f._solve_graphs.clear()
    xc = f.solve(B, refine=0)
    chain(False)
    f._solve_graphs.clear()
    assert _rel(xk, xc) <= TOL[dtype]
    b = B[:, 0]
    assert spfx_torch.scaled_residual(A, f.solve(b), b) <= 1e-12
