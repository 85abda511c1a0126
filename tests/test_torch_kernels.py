"""Each kernel module of the port against its JAX counterpart on the CPU,
with the same seeded numpy inputs: the plain window gathers against the
XLA superwindow gather, the plain potrf_inv against the Pallas kernel in
interpret mode, the blocked panel path, and one real UT update step; and
the kernel build's staleness test on temporary files, the C entry points
against their ctypes signatures, and the kernel probe's cuts against the
sources they edit."""

import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from spfx.kernels import blocks as jblocks
from spfx.kernels import pallas_blocks
from spfx.plan.schedule import build_plan as jbuild_plan
from spfx.symbolic.analyze import analyze as janalyze
from spfx.utils.config import Config as JConfig

from spfx_torch.bench import kernel_probe
from spfx_torch.io import generate
from spfx_torch.kernels import _cuda, blocks, gather, panel
from spfx_torch.plan.schedule import ALIGN, build_plan
from spfx_torch.symbolic.analyze import analyze
from spfx_torch.utils.config import Config
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def _spd(n, seed=0):
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B @ B.T + sp.diags(np.full(n, n * 0.1)))


@pytest.fixture(scope="module", params=["lap6", "spd300"])
def real_plan(request):
    """A real plan of the JAX package, the port's plan of the same matrix
    (identical tables, see test_torch_plan.py) and a seeded flat array of
    the storage size: every slot holds a value, padding included, so any
    gather or mask mistake shows."""
    A = generate.laplacian_3d(6) if request.param == "lap6" else _spd(300)
    cfg = JConfig(dtype="float64")
    plan = jbuild_plan(janalyze(A, cfg), A, cfg)
    tplan = build_plan(analyze(A, Config(dtype="float64")), A,
                       Config(dtype="float64"))
    flat = np.random.default_rng(7).standard_normal(plan.storage)
    return plan, flat, tplan


def _ut_buckets(plan):
    return [ub for lp in plan.levels for ub in lp.updates]


# --------------------------------------------------------------------------
# window gathers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_gather2_matches_xla(real_plan, dtype):
    plan, flat, tplan = real_plan
    npd, td = DTYPES[dtype]
    Lj = jnp.asarray(flat.astype(npd))
    Lt = torch.from_numpy(flat.astype(npd))
    dead = 0
    for ub in _ut_buckets(plan):
        rows_g = ub.mp + ALIGN // ub.kp
        np_h = ub.tgt_cpos.shape[1]
        Gj, Hj = jblocks._pair_gather_aligned(
            Lj, jnp.asarray(ub.src_start), rows_g, jnp.asarray(ub.head_start),
            np_h, ub.kp)
        Gt, Ht = gather.window_gather2(
            Lt, torch.from_numpy(ub.src_start), rows_g * ub.kp,
            torch.from_numpy(ub.head_start), np_h * ub.kp)
        np.testing.assert_array_equal(Gt.numpy().reshape(Gj.shape),
                                      np.asarray(Gj))
        np.testing.assert_array_equal(Ht.numpy().reshape(Hj.shape),
                                      np.asarray(Hj))
        dead += int((ub.src_start < 0).sum())
    assert dead > 0, "no dead task exercised"


def test_window_gather_matches_xla(real_plan):
    plan, flat, tplan = real_plan
    Lj, Lt = jnp.asarray(flat), torch.from_numpy(flat)
    for ub in _ut_buckets(plan)[:8]:
        rows = ub.mp + ALIGN // ub.kp
        ref = jblocks._task_gather_aligned(Lj, jnp.asarray(ub.src_start),
                                           rows, ub.kp)
        out = gather.window_gather(Lt, torch.from_numpy(ub.src_start),
                                   rows * ub.kp)
        np.testing.assert_array_equal(out.numpy().reshape(ref.shape),
                                      np.asarray(ref))


def test_window_gather_dead_windows_are_zero():
    L = torch.arange(4 * ALIGN, dtype=torch.float64) + 1
    s = torch.tensor([-1, 1500, -7], dtype=torch.int32)
    out = gather.window_gather(L, s, ALIGN)
    assert (out[0] == 0).all() and (out[2] == 0).all()
    np.testing.assert_array_equal(out[1].numpy(), L[ALIGN:2 * ALIGN].numpy())


def test_window_gather2_empty_side():
    L = torch.ones(4 * ALIGN, dtype=torch.float32)
    s = torch.tensor([0, 2048], dtype=torch.int32)
    none = torch.zeros(0, dtype=torch.int32)
    a, b = gather.window_gather2(L, none, ALIGN, s, 2 * ALIGN)
    assert a.shape == (0, ALIGN) and b.shape == (2, 2 * ALIGN)
    a, b = gather.window_gather2(L, s, ALIGN, none, ALIGN)
    assert a.shape == (2, ALIGN) and b.shape == (0, ALIGN)


def test_window_gather_rejects_bad_input():
    L = torch.zeros(4 * ALIGN, dtype=torch.float64)
    ok = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError, match="ends past"):
        gather.window_gather(L, torch.tensor([3 * ALIGN + 5],
                                             dtype=torch.int32), 2 * ALIGN)
    with pytest.raises(ValueError, match="int32"):
        gather.window_gather(L, ok.long(), ALIGN)
    with pytest.raises(ValueError, match="not positive"):
        gather.window_gather(L, ok, 0)
    with pytest.raises(ValueError, match="not positive"):
        gather.window_gather2(L, ok, ALIGN, ok, 0)
    with pytest.raises(TypeError):
        gather.window_gather(L.half(), ok, ALIGN)


# --------------------------------------------------------------------------
# the build's staleness test (no nvcc needed)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("newest,want", [
    (None, True), ("lib", False), ("src", True), ("header", True),
    ("other header", True)])
def test_build_staleness_counts_headers(tmp_path, newest, want):
    """A library is built again when it is missing, or when its source or
    any csrc header is as new as it or newer; else it is kept."""
    src, out = tmp_path / "k.cu", tmp_path / "libk.so"
    headers = [tmp_path / "a.cuh", tmp_path / "b.cuh"]
    files = {"src": src, "lib": out, "header": headers[0],
             "other header": headers[1]}
    for f in files.values():
        f.write_text("")
        os.utime(f, (1000, 1000))
    if newest is None:
        out.unlink()
    else:
        os.utime(files[newest], (2000, 2000))
    assert _cuda.stale(str(out), str(src), [str(h) for h in headers]) is want


@pytest.mark.parametrize("name", sorted(_cuda._SIGNATURES))
def test_entry_points_match_signatures(name):
    """The extern "C" functions of csrc/<name>.cu are the ones _cuda binds,
    each with as many parameters as its ctypes signature has types."""
    src = open(os.path.join(_cuda._CSRC, f"{name}.cu")).read()
    found = {m.group(1): len(m.group(2).split(","))
             for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert found == {fn: len(sig)
                     for fn, sig in _cuda._SIGNATURES[name].items()}


def test_every_source_is_bound():
    """Every csrc/*.cu has its signatures in _cuda, so lib() can load it."""
    names = {os.path.splitext(f)[0] for f in os.listdir(_cuda._CSRC)
             if f.endswith(".cu")}
    assert names == set(_cuda._SIGNATURES)


@pytest.mark.parametrize("source,cuts", [
    ("getrf_inv.cu", kernel_probe.GETRF_CUTS),
    ("syrk_gemm.cu", kernel_probe.SYRK_CUTS),
    ("potrf_inv.cu", kernel_probe.POTRF_CUTS),
    ("extend_add.cu", kernel_probe.EXTEND_CUTS),
    ("chol_small.cu", kernel_probe.CHOL_SMALL_CUTS),
    ("getrf_inv_c.cu", kernel_probe.GETRF_C_CUTS),
    ("potrf_inv_c.cu", kernel_probe.POTRF_C_CUTS),
    ("bmm_bf16x3.cu", kernel_probe.BF16X3_CUTS)])
def test_probe_cuts_apply(source, cuts):
    """Every edit of every cut of kernel_probe finds its text exactly once
    in the files it edits (the source and the csrc headers), so that a
    probe never times an uncut copy unawares; the first cut is the whole
    kernel."""
    files = [source] + sorted(f for f in os.listdir(_cuda._CSRC)
                              if f.endswith(".cuh"))
    text = "".join(open(os.path.join(_cuda._CSRC, f)).read() for f in files)
    assert cuts[0] == ("whole", [])
    for name, edits in cuts[1:]:
        assert edits, name
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            assert old != new


@pytest.mark.parametrize("fn", sorted(_cuda._SIGNATURES["extend_add"]))
def test_probe_declared_arity(fn):
    """The probe's reading of a source's declared parameters (how it calls
    an older extend_add source) agrees with _cuda's binding of each entry,
    and sees one parameter fewer once the path flag is taken out."""
    text = open(os.path.join(_cuda._CSRC, "extend_add.cu")).read()
    n = len(_cuda._SIGNATURES["extend_add"][fn])
    assert kernel_probe.declared_arity(text, fn) == n
    old = text.replace("const void* E, int vec,", "const void* E,")
    if fn.startswith("spfx_extend_add_rows_"):
        assert kernel_probe.declared_arity(old, fn) == n - 1
    with pytest.raises(ValueError):
        kernel_probe.declared_arity(text, fn + "_missing")


@pytest.mark.parametrize("lib,fn", [
    ("bmm_bf16x3", "spfx_bmm_bf16x3_fast_f32"),
    ("getrf_inv_c", "spfx_getrf_inv_c64"),
    ("getrf_inv_c", "spfx_getrf_inv_c128"),
    ("potrf_inv_c", "spfx_potrf_inv_c64"),
    ("potrf_inv_c", "spfx_potrf_inv_c128")])
def test_probe_declared_arity_new_entries(lib, fn):
    """The probe reads the parameters of the entries it calls by name in a
    current or a parent source (bmm_bf16x3's, getrf_inv_c's and
    potrf_inv_c's) as _cuda binds them."""
    text = open(os.path.join(_cuda._CSRC, f"{lib}.cu")).read()
    assert kernel_probe.declared_arity(text, fn) == len(
        _cuda._SIGNATURES[lib][fn])


@pytest.mark.parametrize("kind", sorted(kernel_probe.DIAG))
def test_probe_diag_entries(kind):
    """Each diagonal-block mode of the probe names a source whose library
    _cuda binds with one entry per type of the mode, a plain version of
    panel.py with as many outputs as the mode reads back, and cuts that
    start with the whole kernel."""
    src, prefix, cuts, nout, plain, _, _, _, types = kernel_probe.DIAG[kind]
    sigs = _cuda._SIGNATURES[src[:-3]]
    for _, t in types:
        assert len(sigs[prefix + t]) == 5 + nout, t
    w = torch.tensor([2], dtype=torch.int32)
    D = torch.eye(4, dtype=types[0][0])[None] * 4
    assert len(getattr(panel, plain)(w, D)) == nout
    assert cuts[0] == ("whole", [])


def test_probe_widest_block():
    """widest_block picks the first block of the greatest clamped width,
    at B = 1."""
    D = torch.arange(5 * 4 * 4, dtype=torch.float32).view(5, 4, 4)
    calls = [(torch.tensor([1, 0], dtype=torch.int32), D[:2]),
             (torch.tensor([3, 9, 4], dtype=torch.int32), D[2:])]
    w, d = kernel_probe.widest_block(calls)
    assert w.tolist() == [9] and torch.equal(d, D[3:4])


def test_probe_complex_cholesky_plan_calls(monkeypatch):
    """The potrf_c mode's plan context and calls, on a 6^3 magnetic
    Laplacian on the CPU: complex64 (B, nb, nb) blocks, nb <= 32, one call
    per 32 columns of each PC bucket, each Hermitian block factored by the
    plain version with L L^H = D on the live part."""
    small = kernel_probe.magnetic_laplacian
    monkeypatch.setattr(kernel_probe, "magnetic_laplacian",
                        lambda k, unsym=False: small(6, unsym))
    ctx = kernel_probe.plan_context("Cholesky_c64", torch.device("cpu"))
    assert ctx.config.dtype == "complex64"
    calls = kernel_probe.plan_potrf_calls(ctx, torch.device("cpu"))
    assert len(calls) == sum(-(-pb.cp // 32) for lp in ctx.plan.levels
                             for pb in lp.panels)
    for w, D in calls:
        assert D.dtype == torch.complex64 and D.shape[1] <= 32
        assert w.dtype == torch.int32 and w.shape == (D.shape[0],)
    w, D = kernel_probe.widest_block(calls)
    L, _ = panel.potrf_inv_plain(w, D)
    n = int(w[0])
    Dm = panel.masked_block(w, D)[0][0, :n, :n]
    Dm = Dm + Dm.tril(-1).mH
    np.testing.assert_allclose((L[0, :n, :n] @ L[0, :n, :n].mH).numpy(),
                               Dm.numpy(), atol=1e-5 * float(Dm.abs().max()))


@pytest.mark.parametrize("name", ["getrf_inv", "potrf_inv"])
def test_complex_blocks_have_their_library(name):
    """Complex blocks of ``name`` launch from the bound library ``name``_c
    (csrc/``name``_c.cu), which exports both complex entries."""
    sigs = _cuda._SIGNATURES[f"{name}_c"]
    assert {f"spfx_{name}_c64", f"spfx_{name}_c128"} <= set(sigs)


# --------------------------------------------------------------------------
# potrf_inv
# --------------------------------------------------------------------------

def _diag_blocks(B, nb, seed):
    """SPD blocks with junk in the strict upper triangle (never read)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, nb, nb))
    D = X @ np.swapaxes(X, 1, 2) + nb * np.eye(nb)[None]
    return D + np.triu(rng.standard_normal((B, nb, nb)) * 100.0, 1)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10), ("float32", 1e-5)])
@pytest.mark.parametrize("nb", [32, 16])
def test_potrf_inv_matches_pallas(dtype, tol, nb):
    """Plain potrf_inv vs potrf_inv_lanes (interpret mode), transposed to
    the TPU's (nb, nb, B) layout. f32 tolerance: both are float32 column
    recurrences summed in different orders on O(10) entries."""
    npd, _ = DTYPES[dtype]
    B = 8
    D = _diag_blocks(B, nb, 11).astype(npd)
    w = np.array([0, 1, nb - 1, nb, 5, nb // 2, nb, 3], np.int32)
    LT, invT = pallas_blocks.potrf_inv_lanes(
        jnp.asarray(w), jnp.asarray(np.transpose(D, (1, 2, 0))))
    Lj = np.transpose(np.asarray(LT), (2, 0, 1))
    Ij = np.transpose(np.asarray(invT), (2, 0, 1))
    Lt, It = panel.potrf_inv(torch.from_numpy(w), torch.from_numpy(D))
    scale = np.abs(Lj).max()
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=0, atol=tol * scale)
    np.testing.assert_allclose(It.numpy(), Ij, rtol=0, atol=tol)


def test_potrf_inv_contract():
    """Reconstruction on the live part, and the padding contract:
    wrel == 0 gives L = 0 and Linv = I."""
    nb = 32
    D = _diag_blocks(4, nb, 12)
    w = np.array([0, 1, 31, 32], np.int32)
    L, Li = (t.numpy() for t in panel.potrf_inv(torch.from_numpy(w),
                                                 torch.from_numpy(D)))
    assert (L[0] == 0).all()
    np.testing.assert_array_equal(Li[0], np.eye(nb))
    for b, wb in enumerate(w):
        Dl = np.tril(D[b])[:wb, :wb]
        Dl = Dl + np.tril(Dl, -1).T
        np.testing.assert_allclose(L[b][:wb, :wb] @ L[b][:wb, :wb].T, Dl,
                                   atol=1e-10 * np.abs(Dl).max(initial=1))
        assert (L[b][wb:] == 0).all() and (L[b][:, wb:] == 0).all()
        # Linv inverts L with the identity put back on the padding
        Lpad = L[b] + np.diag((np.arange(nb) >= wb).astype(float))
        np.testing.assert_allclose(Li[b] @ Lpad, np.eye(nb), atol=1e-10)
        np.testing.assert_array_equal(Li[b][wb:], np.eye(nb)[wb:])


def test_potrf_inv_rejects_bad_input():
    D = torch.zeros(2, 32, 32)
    with pytest.raises(ValueError, match="wrel"):
        panel.potrf_inv(torch.zeros(2, dtype=torch.int64), D)
    with pytest.raises(ValueError, match="nb"):
        panel.potrf_inv(torch.zeros(2, dtype=torch.int32),
                        torch.zeros(2, 64, 64))
    with pytest.raises(ValueError, match="contiguous"):
        panel.potrf_inv(torch.zeros(2, dtype=torch.int32),
                        D.transpose(1, 2))


# --------------------------------------------------------------------------
# blocked panel path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,cp,rbp,seed", [(8, 16, 32, 3), (4, 64, 128, 4),
                                           (2, 128, 64, 5), (8, 32, 0, 6)])
def test_chol_deltas_blocked_matches_jax(B, cp, rbp, seed):
    """The cases of tests/test_panel_kernels.py: the port's blocked panel
    deltas vs the JAX blocked path (Pallas potrf_inv_lanes interpreted)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, cp, cp))
    Dh = X @ np.swapaxes(X, 1, 2) + cp * np.eye(cp)[None]
    Bh = rng.standard_normal((B, rbp, cp)) if rbp else np.zeros((B, 0, cp))
    w = rng.integers(1, cp + 1, B).astype(np.int32)
    nb = rng.integers(0, rbp + 1, B).astype(np.int32) if rbp \
        else np.zeros(B, np.int32)
    cm = np.arange(cp)[None, :] < w[:, None]
    Dh = np.tril(Dh) * cm[:, None, :] * cm[:, :, None]
    Bh = Bh * cm[:, None, :]
    dd1, db1 = jblocks._chol_deltas_blocked(
        jnp.asarray(Dh), jnp.asarray(Bh), jnp.asarray(w), jnp.asarray(nb),
        cp=cp, rbp=rbp)
    dd2, db2 = blocks._chol_deltas_blocked(
        torch.from_numpy(Dh), torch.from_numpy(Bh), torch.from_numpy(w),
        torch.from_numpy(nb), cp, rbp)
    np.testing.assert_allclose(dd2.numpy(), np.asarray(dd1), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(db2.numpy(), np.asarray(db1), rtol=1e-10,
                               atol=1e-10)


# --------------------------------------------------------------------------
# one UT update step
# --------------------------------------------------------------------------

def _largest_ut(plan, tplan):
    """The UT bucket with the most live tasks, in both plans."""
    i = max(range(len(_ut_buckets(plan))),
            key=lambda i: int((_ut_buckets(plan)[i].kw > 0).sum()))
    return _ut_buckets(plan)[i], _ut_buckets(tplan)[i]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_update_rows_matches_jax(real_plan, dtype):
    plan, flat, tplan = real_plan
    npd, _ = DTYPES[dtype]
    ub, tub = _largest_ut(plan, tplan)
    d = ub.dev()
    Ej = jblocks.update_rows_sym_t(
        jnp.asarray(flat.astype(npd)), *d[:5], d[-1], mp=ub.mp, kp=ub.kp,
        csp=ub.csp)
    t = tub.to("cpu")
    Et = blocks.update_rows_sym_t(
        torch.from_numpy(flat.astype(npd)), *t[:5], t[-1], mp=ub.mp,
        kp=ub.kp, csp=ub.csp)
    tol = 1e-12 if dtype == "float64" else 1e-5
    scale = np.abs(np.asarray(Ej)).max()
    np.testing.assert_allclose(Et.numpy(), np.asarray(Ej), rtol=0,
                               atol=tol * scale)


@pytest.mark.parametrize("dtype,steps", [
    ("float32", "largest"), ("float64", "largest"),
    ("float32", "every"), ("float64", "every")],
    ids=["float32", "float64", "float32-every", "float64-every"])
def test_ut_step_matches_jax(real_plan, dtype, steps):
    """update rows + extend-add, in place, vs apply_updates_sym_t: the
    largest UT step, or every UT step of the plan in turn. Each step
    writes only its slab. f32 tolerance: the JAX extend-add sums a group's
    rows that share a slab row before subtracting; the port subtracts them
    one by one."""
    plan, flat, tplan = real_plan
    npd, _ = DTYPES[dtype]
    pairs = ([_largest_ut(plan, tplan)] if steps == "largest"
             else list(zip(_ut_buckets(plan), _ut_buckets(tplan))))
    Lj = jnp.asarray(flat.astype(npd))
    Lt = torch.from_numpy(flat.astype(npd))
    for ub, tub in pairs:
        Lj = jblocks.apply_updates_sym_t(
            Lj, *ub.dev(), mp=ub.mp, kp=ub.kp, csp=ub.csp,
            srows=ub.slab_rows)
        kw, mrows, rstart, src, head, *_, cpos = tub.to("cpu")
        before = Lt.clone()
        out = blocks.apply_updates_sym_t(
            Lt, kw, mrows, rstart, src, head, int(ub.slab_lo[0]),
            tub.to("cpu")[6], cpos, mp=ub.mp, kp=ub.kp, csp=ub.csp,
            srows=ub.slab_rows)
        assert out is Lt                             # in place
        lo = int(ub.slab_lo[0])
        hi = lo + ub.slab_rows * ub.csp
        assert torch.equal(Lt[:lo], before[:lo])
        assert torch.equal(Lt[hi:], before[hi:])
    Lj = np.asarray(Lj)
    changed = Lj != flat.astype(npd)
    assert changed.sum() > 0
    tol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=0,
                               atol=tol * np.abs(Lj).max())


def test_assemble_matches_jax(real_plan):
    plan, _, _ = real_plan
    vals = np.random.default_rng(3).standard_normal(len(plan.assembly_idx))
    ref = jblocks.assemble(jnp.asarray(plan.assembly_idx.astype(np.int32)),
                           jnp.asarray(vals), plan.storage)
    out = blocks.assemble(torch.from_numpy(plan.assembly_idx),
                          torch.from_numpy(vals), plan.storage)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_factor_panels_in_place(real_plan):
    """A PC step writes only its bucket's uniform block."""
    plan, flat, tplan = real_plan
    pb = max((pb for lp in tplan.levels for pb in lp.panels),
             key=lambda pb: pb.cp)
    S = (pb.cp + pb.rbp) * pb.cp
    lo = int(pb.slab_lo[0])
    hi = lo + len(pb.widths) * S
    # an SPD-ish panel block: identity-heavy diagonal blocks
    L = torch.from_numpy(flat * 1e-3)
    blk = L[lo:hi].view(-1, pb.cp + pb.rbp, pb.cp)
    blk[:, :pb.cp, :] += 10 * torch.eye(pb.cp, dtype=L.dtype)
    before = L.clone()
    w, nb, _ = pb.to_u("cpu")
    blocks.factor_panels_chol_u(L, w, nb, lo, pb.cp, pb.rbp)
    assert torch.isfinite(L).all()
    assert torch.equal(L[:lo], before[:lo]) and torch.equal(L[hi:],
                                                            before[hi:])
    assert not torch.equal(L[lo:hi], before[lo:hi])
