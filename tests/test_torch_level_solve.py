"""The level-solve kernel's algorithm (spfx_torch.kernels.level_solve) on
the CPU: its plain version, task by task over 32-column diagonal blocks,
against JAX's solve_fwd_level_c / solve_bwd_level_c and against the port's
torch chain at every PC bucket of small plans (Cholesky and LU, float32 and
float64, one and sixteen right-hand sides; the buckets hold pad tasks, dead
columns and rows, and tasks wider than one diagonal block); which buckets
the device solve sends to the kernel, decided without a launch; the
wrapper's refusals (the CPU among them: it takes the chain); and the step
counters of an eager solve. The kernel
itself is held against the chain on the card
(tests/test_torch_level_solve_card.py)."""

import dataclasses
import functools
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

import spfx
from spfx.kernels import blocks as jblocks

import spfx_torch
from spfx_torch import Config
from spfx_torch.io import generate
from spfx_torch.kernels import blocks, level_solve
from spfx_torch.kernels.mega import MegaSolver
from spfx_torch.plan.schedule import PanelBucket, PanelBucketC
from spfx_torch.utils import instrument
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

# relative to max|x|: the sums run in other orders than JAX's and the
# chain's (f64), and the same at float32's epsilon
TOL = {"float32": 1e-5, "float64": 1e-12}


def _spd(n, seed=0):
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B @ B.T + sp.diags(np.full(n, n * 0.1)))


def _unsym(n, seed=1):
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B + sp.diags(np.abs(B).sum(axis=1).A1 + 1.0))


MATRICES = {"lap6": lambda: generate.laplacian_3d(6),
            "spd300": lambda: _spd(300),
            "unsym300": lambda: _unsym(300)}


@functools.lru_cache(maxsize=None)
def _case(name: str, lu: bool):
    """(n, the JAX factor's arrays (forward's, backward's) in f64, JAX's
    PC buckets, the port's), at the JAX per-call engine's factor."""
    A = MATRICES[name]()
    kind = spfx.LU if lu else spfx.Cholesky
    jf = kind(A, spfx.Config(dtype="float64", engine="calls")).factorize(A)
    F64 = (np.asarray(jf.Lx), np.asarray(jf.Ux)) if lu \
        else (np.asarray(jf.L),) * 2
    tkind = spfx_torch.LU if lu else spfx_torch.Cholesky
    tplan = tkind(A, Config(dtype="float64"), device="cpu").plan
    jpbs = [pb for lp in jf.plan.levels for pb in lp.panels]
    tpbs = [pb for lp in tplan.levels for pb in lp.panels]
    assert len(jpbs) == len(tpbs) > 1
    return A.shape[0], F64, jpbs, tpbs


CASES = [(m, lu, d, k) for m, lu in (("lap6", False), ("spd300", False),
                                     ("lap6", True), ("unsym300", True))
         for d in ("float32", "float64") for k in (1, 16)]


@pytest.mark.parametrize(
    "name,lu,dtype,nrhs", CASES,
    ids=[f"{m}-{'lu' if lu else 'chol'}-{d}-{k}" for m, lu, d, k in CASES])
def test_plain_matches_jax_and_chain(name, lu, dtype, nrhs):
    """At every PC bucket in level order forward, then in reverse
    backward, on the same x (n + 1, nrhs): the plain version within TOL of
    JAX's level solve and of the chain, on every row but the sentinel,
    which it leaves as it was."""
    n, F64, jpbs, tpbs = _case(name, lu)
    F = [torch.from_numpy(f.astype(dtype)) for f in F64]
    x = np.zeros((n + 1, nrhs), dtype)
    x[:n] = np.random.default_rng(nrhs).standard_normal((n, nrhs))
    x[n] = 7.0                     # the sentinel: never read nor written
    sweeps = ((True, F[0], list(zip(jpbs, tpbs))),
              (False, F[1], list(zip(jpbs, tpbs))[::-1]))
    for fwd, Fk, pairs in sweeps:
        jfn = jblocks.solve_fwd_level_c if fwd else jblocks.solve_bwd_level_c
        cfn = blocks.solve_fwd_level_c if fwd else blocks.solve_bwd_level_c
        for jp, tp in pairs:
            assert (jp.cp, jp.rbp) == (tp.cp, tp.rbp)
            xj = np.asarray(jfn(jnp.asarray(Fk.numpy()), jnp.asarray(x),
                                *jp.dev(), cp=jp.cp, rbp=jp.rbp, lu=lu))
            xc = cfn(Fk, torch.from_numpy(x.copy()), *tp.to("cpu"),
                     cp=tp.cp, rbp=tp.rbp, lu=lu).numpy()
            xt = torch.from_numpy(x.copy())
            if fwd:
                out = level_solve.level_solve_fwd_plain(
                    Fk, xt, *tp.to("cpu"), cp=tp.cp, rbp=tp.rbp, unit=lu)
            else:
                out = level_solve.level_solve_bwd_plain(
                    Fk, xt, *tp.to("cpu"), cp=tp.cp, rbp=tp.rbp)
            assert out is xt
            scale = np.abs(xj[:n]).max()
            for want in (xj, xc):
                np.testing.assert_allclose(xt.numpy()[:n], want[:n], rtol=0,
                                           atol=TOL[dtype] * scale)
            assert (xt.numpy()[n] == 7.0).all()
            x = xj.copy()
            x[n] = 7.0


@pytest.mark.parametrize("name,lu", [("lap6", False), ("spd300", False),
                                     ("unsym300", True)])
def test_cases_hold_the_edges(name, lu):
    """The plans above hold what the kernel skips by predicate: pad tasks,
    dead columns and dead rows; and tasks wider than one 32-column
    diagonal block (a bucket of one task: test_plain_one_task_bucket)."""
    _, _, _, tpbs = _case(name, lu)
    assert any((pb.diag_start < 0).any() for pb in tpbs)
    assert any(((pb.widths < pb.cp) & (pb.diag_start >= 0)).any()
               for pb in tpbs)
    assert any(((pb.nbelow < pb.rbp) & (pb.diag_start >= 0)).any()
               for pb in tpbs)
    assert any((pb.widths > level_solve.BLK).any() for pb in tpbs)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_one_task_bucket(dtype):
    """A bucket of one task (B = 1, the top of a large plan's tree), two
    diagonal blocks wide, with more rows below than one of the kernel's
    row tiles and a -1 among its live rows: the plain version against
    JAX's level solves and the chain, both sweeps, unit and not. The
    sentinel row holds 0, as in a solve, where the chain's read of it
    for the -1 adds nothing; the plain version leaves it alone."""
    rng = np.random.default_rng(5)
    cp, rbp, w, nb, n = 48, level_solve.CH_MAX + 70, 41, 300, 700
    L11 = np.tril(rng.standard_normal((cp, cp))) * 0.1 + 3.0 * np.eye(cp)
    L21 = rng.standard_normal((rbp, cp))
    F = torch.from_numpy(np.concatenate([L11.ravel(), L21.ravel()]).astype(
        dtype))
    perm = rng.permutation(n)
    xcols = np.full((1, cp), -1, np.int32)
    xrows = np.full((1, rbp), -1, np.int32)
    xcols[0, :w] = perm[:w]
    xrows[0, :nb] = perm[w:w + nb]
    xrows[0, 17] = -1                        # a -1 inside the live rows
    tab = [torch.tensor(a, dtype=torch.int32) for a in (
        [w], [nb], [0], [cp * cp])] + [torch.from_numpy(xcols),
                                       torch.from_numpy(xrows)]
    x0 = torch.from_numpy(rng.standard_normal((n + 1, 3)).astype(dtype))
    x0[n] = 0
    jargs = (jnp.asarray(F.numpy()),)
    jtab = [jnp.asarray(t.numpy()) for t in tab]
    for fwd in (True, False):
        for unit in ((False, True) if fwd else (False,)):
            xt, xc = x0.clone(), x0.clone()
            if fwd:
                level_solve.level_solve_fwd_plain(F, xt, *tab, cp=cp,
                                                  rbp=rbp, unit=unit)
                blocks.solve_fwd_level_c(F, xc, *tab, cp=cp, rbp=rbp,
                                         lu=unit)
                xj = jblocks.solve_fwd_level_c(*jargs, jnp.asarray(x0),
                                               *jtab, cp=cp, rbp=rbp,
                                               lu=unit)
            else:
                level_solve.level_solve_bwd_plain(F, xt, *tab, cp=cp,
                                                  rbp=rbp)
                blocks.solve_bwd_level_c(F, xc, *tab, cp=cp, rbp=rbp)
                xj = jblocks.solve_bwd_level_c(*jargs, jnp.asarray(x0),
                                               *jtab, cp=cp, rbp=rbp)
            for want in (xc.numpy(), np.asarray(xj)):
                np.testing.assert_allclose(
                    xt[:n].numpy(), want[:n], rtol=0,
                    atol=TOL[dtype] * np.abs(want[:n]).max())
            assert torch.equal(xt[n], x0[n])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_wide_bucket(dtype):
    """A bucket wider than CP_SHARED (the kernel keeps its y in a global
    workspace): one live task and one pad task, dead columns and rows, a
    -1 among the live columns; the plain version against the chain, both
    sweeps, unit and not, the sentinel left alone."""
    rng = np.random.default_rng(9)
    cp, rbp = level_solve.CP_SHARED + 40, 300
    w, nb, n = cp - 14, rbp - 20, 1500
    L11 = (np.tril(rng.standard_normal((cp, cp))) * 0.5 / np.sqrt(cp)
           + 2.0 * np.eye(cp))
    L21 = rng.standard_normal((rbp, cp)) / np.sqrt(cp)
    blk = np.concatenate([L11.ravel(), L21.ravel()])
    F = torch.from_numpy(np.concatenate([blk, blk]).astype(dtype))
    perm = rng.permutation(n)
    xcols = np.full((2, cp), -1, np.int32)
    xrows = np.full((2, rbp), -1, np.int32)
    xcols[0, :w] = perm[:w]
    xcols[0, 5] = -1                         # a -1 inside the live columns
    xrows[0, :nb] = perm[w:w + nb]
    tab = [torch.tensor(a, dtype=torch.int32) for a in (
        [w, cp], [nb, rbp], [0, -1], [cp * cp, -1])] + [
        torch.from_numpy(xcols), torch.from_numpy(xrows)]
    x0 = torch.from_numpy(rng.standard_normal((n + 1, 3)).astype(dtype))
    x0[n] = 0
    for fwd in (True, False):
        for unit in ((False, True) if fwd else (False,)):
            xt, xc = x0.clone(), x0.clone()
            if fwd:
                level_solve.level_solve_fwd_plain(F, xt, *tab, cp=cp,
                                                  rbp=rbp, unit=unit)
                blocks.solve_fwd_level_c(F, xc, *tab, cp=cp, rbp=rbp,
                                         lu=unit)
            else:
                level_solve.level_solve_bwd_plain(F, xt, *tab, cp=cp,
                                                  rbp=rbp)
                blocks.solve_bwd_level_c(F, xc, *tab, cp=cp, rbp=rbp)
            np.testing.assert_allclose(
                xt[:n].numpy(), xc[:n].numpy(), rtol=0,
                atol=TOL[dtype] * np.abs(xc[:n].numpy()).max())
            assert torch.equal(xt[n], x0[n])


# --------------------------------------------------------------------------
# the route: which buckets take the kernel
# --------------------------------------------------------------------------

def _stand_in(device: str, dtype):
    """An object with a factor array's device and dtype, for ``takes``."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


@functools.lru_cache(maxsize=None)
def _plans():
    A = generate.laplacian_3d(5)
    contig = spfx_torch.Cholesky(A, Config(), device="cpu").plan
    rowwin = spfx_torch.Cholesky(A, Config(layout="rowwin"),
                                 device="cpu").plan
    return contig, rowwin


@pytest.mark.parametrize("device,dtype,want", [
    ("cuda", torch.float32, True), ("cuda", torch.float64, True),
    ("cuda", torch.complex64, False), ("cuda", torch.complex128, False),
    ("cpu", torch.float32, False), ("cpu", torch.float64, False)])
def test_route_of_pc_buckets(device, dtype, want):
    """A PC bucket takes the kernel on a CUDA device with a real factor,
    the chain on the CPU and with a complex one; nothing is launched."""
    contig, _ = _plans()
    F = _stand_in(device, dtype)
    for pb in (pb for lp in contig.levels for pb in lp.panels):
        assert isinstance(pb, PanelBucketC)
        assert level_solve.takes(F, pb) is want
    assert level_solve._cuda.launch_counts()["level_solve"] == 0


def test_route_of_rowwin_and_wide_buckets():
    """Rowwin P buckets keep the chain on the card; a PC bucket of any
    width takes the kernel, past CP_SHARED as below it."""
    contig, rowwin = _plans()
    F = _stand_in("cuda", torch.float32)
    for pb in (pb for lp in rowwin.levels for pb in lp.panels):
        assert isinstance(pb, PanelBucket)
        assert level_solve.takes(F, pb) is False
    pb = contig.levels[0].panels[0]
    for cp in (level_solve.CP_SHARED, level_solve.CP_SHARED + 32, 4096):
        assert level_solve.takes(F, dataclasses.replace(pb, cp=cp)) is True


@pytest.mark.parametrize("kernel", ["all", "none", "eager"])
def test_step_paths(kernel):
    """MegaSolver.steps counts both sweeps' bucket steps by path from a
    capture's launch counts: the kernel's launches, and the chain the
    rest; an eager solve (no capture) counts every step on the chain."""
    contig, _ = _plans()
    s = MegaSolver(contig, config=Config(), device="cpu")
    steps = 2 * sum(len(lp.panels) for lp in contig.levels)
    launches = {"all": {"level_solve": steps, "potrf_inv": 3},
                "none": {"level_solve": 0}, "eager": None}[kernel]
    assert s.steps(launches) == ({"kernel": steps, "chain": 0}
                                 if kernel == "all"
                                 else {"kernel": 0, "chain": steps})


# --------------------------------------------------------------------------
# the wrapper's refusals
# --------------------------------------------------------------------------

def _small():
    """(F, x, tables, cp, rbp) of one valid bucket of two tasks: identity
    diagonal blocks; task 0 four columns wide with three rows below, its
    L21 all ones; task 1 two columns wide with none."""
    cp, rbp, n = 4, 3, 10
    eye = torch.eye(cp, dtype=torch.float64).ravel()
    F = torch.cat([eye, eye, torch.ones(rbp * cp, dtype=torch.float64)])
    x = torch.ones((n + 1, 2), dtype=torch.float64)
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    tables = [i32([4, 2]), i32([3, 0]), i32([0, cp * cp]),
              i32([2 * cp * cp, -1]), i32([[0, 1, 2, 3], [4, 5, -1, -1]]),
              i32([[6, 7, 8], [-1, -1, -1]])]
    return F, x, tables, cp, rbp


def test_small_bucket_runs():
    """The valid bucket of the refusal tests goes through both sweeps of
    the plain version: forward, x[6:9] -= 4 (four ones a row times
    y = 1); backward, task 0's columns take 1 - 3 (-3) = 10; the rest and
    the sentinel stay 1. The wrappers refuse it on the CPU."""
    F, x, tables, cp, rbp = _small()
    level_solve.level_solve_fwd_plain(F, x, *tables, cp=cp, rbp=rbp)
    want = torch.ones_like(x)
    want[6:9] = -3
    assert torch.equal(x, want)
    level_solve.level_solve_bwd_plain(F, x, *tables, cp=cp, rbp=rbp)
    want[:4] = 10
    assert torch.equal(x, want)
    for fn in (level_solve.level_solve_fwd, level_solve.level_solve_bwd):
        with pytest.raises(ValueError, match="CUDA"):
            fn(F, x, *tables, cp=cp, rbp=rbp)
    assert torch.equal(x, want)


def _refusals():
    def f16(F, x, t):
        return F.half(), x.half(), t

    def mixed(F, x, t):
        return F, x.float(), t

    def cplx(F, x, t):
        return F.to(torch.complex64), x.to(torch.complex64), t

    def meta(F, x, t):
        return F.to("meta"), x.to("meta"), [a.to("meta") for a in t]

    def int64(F, x, t):
        return F, x, [t[0].long()] + t[1:]

    def cols_shape(F, x, t):
        return F, x, t[:4] + [t[4][:, :3].contiguous(), t[5]]

    def rows_shape(F, x, t):
        return F, x, t[:5] + [t[5][:1]]

    def strided_x(F, x, t):
        return F, torch.ones((x.shape[0], 4), dtype=x.dtype)[:, ::2], t

    def flat_x(F, x, t):
        return F, x[:, 0].contiguous(), t

    def square_F(F, x, t):
        return F.view(-1, 4), x, t

    def cpu(F, x, t):
        return F, x, t

    return [("f16", f16, TypeError, "float32 or float64"),
            ("mixed", mixed, TypeError, "x is"),
            ("complex", cplx, TypeError, "float32 or float64"),
            ("meta", meta, ValueError, "device"),
            ("int64", int64, TypeError, "int32"),
            ("cols", cols_shape, ValueError, "xcols"),
            ("rows", rows_shape, ValueError, "xrows"),
            ("strided", strided_x, ValueError, "contiguous"),
            ("flat", flat_x, ValueError, "nrhs"),
            ("square", square_F, ValueError, "flat"),
            ("cpu", cpu, ValueError, "CUDA device")]


@pytest.mark.parametrize("what,edit,exc,match", _refusals(),
                         ids=[r[0] for r in _refusals()])
@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "bwd"])
def test_wrapper_refuses(what, edit, exc, match, fwd):
    F, x, tables, cp, rbp = _small()
    F, x, tables = edit(F, x, tables)
    fn = level_solve.level_solve_fwd if fwd else level_solve.level_solve_bwd
    with pytest.raises(exc, match=match):
        fn(F, x, *tables, cp=cp, rbp=rbp)


@pytest.mark.parametrize("cp,rbp,match", [(0, 3, "cp"),
                                          (-5, 3, "cp"),
                                          (4, -1, "rbp")])
def test_wrapper_refuses_widths(cp, rbp, match):
    F, x, tables, _, _ = _small()
    with pytest.raises(ValueError, match=match):
        level_solve.level_solve_fwd(F, x, *tables, cp=cp, rbp=rbp)


@pytest.mark.parametrize("item", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("cp", [1, 32, 33, 64, 256, 257, 512,
                                level_solve.CP_SHARED,
                                level_solve.CP_SHARED + 1, 2304, 8192])
def test_launch_shape_fits_the_card(cp, item):
    """The rows a job and a tile (``ch``: whole 32-row blocks, from CH_MIN
    to CH_MAX, at least the bucket's extent up to CH_MAX) and the staging
    buffers in flight (2 to 4) that the wrapper passes the kernel, at
    every row count below: the shared memory the kernel asks for (y up to
    CP_SHARED columns, the tile's x, the buffers of ch padded rows) stays
    within the H100's 227 KiB a thread block, whatever the width."""
    for rbp in (0, 1, 31, 32, 100, 256, 257, 2560):
        ch = level_solve._chunk(cp, rbp)
        assert ch % level_solve.BLK == 0
        assert max(level_solve.CH_MIN, min(level_solve.CH_MAX,
                                           max(cp, rbp))) <= ch \
            <= level_solve.CH_MAX
        nbuf = level_solve._depth(cp, ch, item)
        assert 2 <= nbuf <= 4
        cpad = -(-cp // level_solve.BLK) * level_solve.BLK
        assert level_solve._y_shared(cp) is (cp <= level_solve.CP_SHARED)
        if not level_solve._y_shared(cp):
            cpad = 0                       # y lives in the workspace
        smem = item * ((cpad + ch) * level_solve.RHS_GROUP
                       + nbuf * ch * (level_solve.BLK + 1))
        assert smem <= 227 * 1024
        tiles = level_solve._tiles(rbp, ch)
        assert tiles * ch >= rbp and (tiles == 1 or (tiles - 1) * ch < rbp)


# --------------------------------------------------------------------------
# the step counters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_counters_of_an_eager_solve(lu):
    """On the CPU every bucket step of a device solve takes the chain:
    solve_chain_steps counts both sweeps' steps a pass, solve_kernel_steps
    reads 0; each solve request holds its own counts."""
    instrument.enable(True)
    instrument.clear()
    try:
        A = generate.laplacian_3d(5)
        kind = spfx_torch.LU if lu else spfx_torch.Cholesky
        ctx = kind(A, Config(dtype="float64", solve_backend="device"),
                   device="cpu")
        f = ctx.factorize(A)
        steps = 2 * sum(len(lp.panels) for lp in ctx.plan.levels)
        f.solve(spfx_torch.synth_rhs(A))
        snap = instrument.snapshot()
        c = snap["counters"]
        assert c["solve_kernel_steps"] == 0
        assert c["solve_chain_steps"] == steps * c["solve_passes"]
        (req,) = [r for r in snap["requests"] if r["kind"] == "spfx.solve"]
        k = req["counters"]
        assert k["solve_chain_steps"] == steps * k["solve_passes"]
        assert k["solve_kernel_steps"] == 0
    finally:
        instrument.enable(True)
        instrument.clear()
