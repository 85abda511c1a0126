"""The port's stage-streamed engines (spfx_torch.stream) against the JAX
package's (spfx.stream) and against the port's in-core engines, on the
CPU.

Tiny stage caps force several host<->device stages. The stage tables
(own region, packed sources and their bases, buffer sizes, the rebased
bucket tables) equal JAX's stage by stage; the factors equal JAX's
streamed factors within 1e-12 (float64) of their largest entry, and the
port's in-core factors within 1e-12 (float64) and 1e-5 (float32). The
2^31 int32 ceiling itself cannot be exercised here (it needs more than
8 GB); what is tested is the mechanism that lifts it: int64 global plans,
per-stage rebasing to int32 tables and host-resident factors.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytest.importorskip("jax")

from spfx.stream import StreamingCholesky as JStreamingCholesky
from spfx.stream import StreamingLU as JStreamingLU
from spfx.utils.config import Config as JConfig

import spfx_torch
from spfx_torch import Config
from spfx_torch.chol.factorize import check_windows
from spfx_torch.io import generate
from spfx_torch.plan.schedule import ALIGN, build_plan
from spfx_torch.stream import StreamingCholesky, StreamingLU, engine
from spfx_torch.symbolic.analyze import analyze
from spfx_torch.validate import scaled_residual, synth_rhs
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

CFG = Config(dtype="float64", ordering="nd", solve_backend="device")
JCFG = JConfig(dtype="float64", ordering="nd", solve_backend="device")
KINDS = {False: (StreamingCholesky, JStreamingCholesky),
         True: (StreamingLU, JStreamingLU)}


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def factor_arrays(f):
    return (f.Lx, f.Ux) if hasattr(f, "Ux") else (f.L,)


def random_unsym(n=500, seed=11):
    """The JAX test's diagonally dominant random unsymmetric matrix."""
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B + sp.diags(np.abs(B).sum(axis=1).A1 + 1.0))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

STAGE_CASES = [(False, 6, 1 << 12), (False, 7, 1 << 13), (True, 6, 1 << 15)]


@pytest.mark.parametrize("lu, k, cap", STAGE_CASES,
                         ids=["chol-6-4096", "chol-7-8192", "lu-6-32768"])
def test_stage_tables_match_jax(lu, k, cap):
    A = generate.laplacian_3d(k)
    port, ref = KINDS[lu]
    st = port(A, CFG, stage_elems=cap, device="cpu")
    jst = ref(A, JCFG, stage_elems=cap)
    assert len(st.stages) == len(jst.stages) > 1
    for s, j in zip(st.stages, jst.stages):
        for name in ("lo", "hi", "packed", "storage"):
            assert getattr(s, name) == getattr(j, name), name
        for name in ("src_sns", "src_lo", "src_len", "src_base"):
            assert np.array_equal(getattr(s, name), getattr(j, name)), name
        assert len(s.levels) == len(j.levels)
        for sl, jl in zip(s.levels, j.levels):
            for sb, jb in zip(sl.panels + sl.updates, jl.panels + jl.updates):
                for name in ("diag_start", "below_start", "slab_lo",
                             "src_start", "head_start", "rstart", "kw",
                             "mrows", "tgt_lrow", "tgt_cpos", "widths",
                             "nbelow"):
                    a, b = getattr(sb, name, None), getattr(jb, name, None)
                    assert (a is None) == (b is None), name
                    if a is not None:
                        assert a.dtype == np.int32, name
                        assert np.array_equal(a, np.asarray(b)), name


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_streaming_matches_jax(lu):
    A = generate.laplacian_3d(6)
    cap = 1 << 15 if lu else 1 << 14
    port, ref = KINDS[lu]
    st = port(A, CFG, stage_elems=cap, device="cpu")
    assert len(st.stages) > 1
    f = st.factorize(A)
    jf = ref(A, JCFG, stage_elems=cap).factorize(A)
    for got, want in zip(factor_arrays(f), factor_arrays(jf)):
        assert rel(got.numpy(), want) <= 1e-12
    b = synth_rhs(A)
    assert scaled_residual(A, f.solve(b), b) < 1e-12


# ---------------------------------------------------------------------------
# the device caches of rebased buckets
# ---------------------------------------------------------------------------

def test_rebased_bucket_gets_fresh_device_caches():
    """Upload the global plan's tables first, then rebase: a rebased bucket
    must not inherit its original's uploaded (un-rebased) tables."""
    A = generate.laplacian_3d(6)
    st = StreamingCholesky(A, CFG, stage_elems=1 << 12, device="cpu")
    for lp in st.plan.levels:
        for ub in lp.updates:
            ub.to("cpu")
        for pb in lp.panels:
            pb.to("cpu")
            pb.to_u("cpu")
    st._build_stages()
    originals = {id(b._dev) for lp in st.plan.levels
                 for b in lp.updates + lp.panels}
    for stage in st.stages:
        for lvl in stage.levels:
            for b in lvl.updates + lvl.panels:
                assert id(b._dev) not in originals and b._dev == {}
    f = st.factorize(A)
    ref = spfx_torch.Cholesky(A, CFG, device="cpu").factorize(A)
    assert rel(f.L.numpy(), ref.L.numpy()) <= 1e-12
    # and the walk uploaded the REBASED starts
    for stage in st.stages:
        for lvl in stage.levels:
            for ub in lvl.updates:
                src = ub.to("cpu")[3]
                assert np.array_equal(src.numpy(), ub.src_start)


def test_rebased_keeps_other_tables():
    A = generate.laplacian_3d(5)
    plan = build_plan(analyze(A, CFG), A, CFG, idx_dtype=np.int64)
    ub = next(u for lp in plan.levels for u in lp.updates)
    ub.to("cpu")
    nb = engine._rebased(ub, src_start=ub.src_start.astype(np.int32))
    assert nb._dev == {} and ub._dev
    assert nb.kw.dtype == np.int32 and np.array_equal(nb.kw, ub.kw)
    assert nb.mp == ub.mp and nb.csp == ub.csp


# ---------------------------------------------------------------------------
# the JAX package's tests (tests/test_stream.py), run on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage_elems", [1 << 12, 1 << 14])
def test_streaming_matches_incore(stage_elems):
    A = generate.laplacian_3d(6)
    st = StreamingCholesky(A, CFG, stage_elems=stage_elems, device="cpu")
    assert len(st.stages) > 1, "cap too big: nothing streamed"
    f = st.factorize(A)
    ref = spfx_torch.Cholesky(A, CFG, device="cpu").factorize(A)
    np.testing.assert_allclose(f.L.numpy(), ref.L.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_streaming_residual():
    A = generate.laplacian_3d(7)
    st = StreamingCholesky(A, CFG, stage_elems=1 << 14, device="cpu")
    assert len(st.stages) > 2
    f = st.factorize(A)
    b = synth_rhs(A)
    x = f.solve(b)
    assert scaled_residual(A, x, b) < 1e-12


def test_streaming_single_stage_degenerates():
    A = generate.laplacian_2d(12)
    st = StreamingCholesky(A, CFG, stage_elems=1 << 28, device="cpu")
    assert len(st.stages) == 1
    f = st.factorize(A)
    b = synth_rhs(A)
    x = f.solve(b)
    assert scaled_residual(A, x, b) < 1e-12


def test_int64_plan_tables():
    A = generate.laplacian_2d(10)
    sym = analyze(A, CFG)
    plan = build_plan(sym, A, CFG, idx_dtype=np.int64)
    for lp in plan.levels:
        for pb in lp.panels:
            assert pb.diag_start.dtype == np.int64
        for ub in lp.updates:
            assert ub.src_start.dtype == np.int64
            assert ub.sds is not None


def test_streaming_lu_matches_incore():
    """StreamingLU matches the in-core LU across a multi-stage split."""
    A = random_unsym()
    st = StreamingLU(A, CFG, stage_elems=1 << 14, device="cpu")
    assert len(st.stages) > 1, "cap too big: nothing streamed"
    f = st.factorize(A)
    ref = spfx_torch.LU(A, CFG, device="cpu").factorize(A)
    np.testing.assert_allclose(f.Lx.numpy(), ref.Lx.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(f.Ux.numpy(), ref.Ux.numpy(), rtol=1e-12,
                               atol=1e-12)
    b = synth_rhs(A)
    x = f.solve(b)
    assert scaled_residual(A, x, b) < 1e-12


def test_streaming_lu_poisson_residual():
    A = generate.laplacian_3d(6)
    st = StreamingLU(A, CFG, stage_elems=1 << 15, device="cpu")
    assert len(st.stages) > 1
    f = st.factorize(A)
    b = synth_rhs(A)
    x = f.solve(b)
    assert scaled_residual(A, x, b) < 1e-12


def test_stage_buffers_cover_dma_superwindows():
    """Every rebased gather superwindow (aligned DOWN to the ALIGN tile,
    extended by ext rows) fits inside its stage buffer (the stage storage
    uses the plan's computed slack, not the module SLACK floor)."""
    A = generate.laplacian_3d(7)
    st = StreamingCholesky(A, CFG, stage_elems=1 << 13, device="cpu")
    assert len(st.stages) > 2
    for stage in st.stages:
        for lvl in stage.levels:
            for ub in lvl.updates:
                if ub.head_start is None:
                    continue
                ext = ALIGN // ub.kp
                for starts, rows in ((ub.src_start, ub.mp + ext),
                                     (ub.head_start,
                                      ub.tgt_cpos.shape[1])):
                    s = np.asarray(starts, np.int64)
                    s = s[s >= 0]
                    if not len(s):
                        continue
                    al = (s // ALIGN) * ALIGN
                    assert (al + rows * ub.kp <= stage.storage).all(), \
                        (int((al + rows * ub.kp).max()), stage.storage)
        # packed sources and the own region keep their global starts mod
        # ALIGN, so the rebased superwindows align down as the global ones
        assert not ((stage.src_base - stage.src_lo) % ALIGN).any()
        assert (stage.packed - stage.lo) % ALIGN == 0


# ---------------------------------------------------------------------------
# the port's own checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_streaming_f32_matches_incore(lu):
    A = generate.laplacian_3d(6)
    cfg = Config()
    port = KINDS[lu][0]
    st = port(A, cfg, stage_elems=1 << 14, device="cpu")
    assert len(st.stages) > 1
    f = st.factorize(A)
    ref = (spfx_torch.LU if lu else spfx_torch.Cholesky)(
        A, cfg, device="cpu").factorize(A)
    for got, want in zip(factor_arrays(f), factor_arrays(ref)):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert rel(got.numpy(), want.numpy()) <= 1e-5
    b = synth_rhs(A)
    assert scaled_residual(A, f.solve(b), b) < 1e-12


def test_stage_plans_pass_window_checks():
    """Each stage's rebased levels, as a plan over the stage buffer, pass
    the in-core engine's window checks; a buffer one superwindow short
    does not."""
    A = generate.laplacian_3d(7)
    st = StreamingCholesky(A, CFG, stage_elems=1 << 13, device="cpu")
    for stage in st.stages:
        check_windows(st.stage_plan(stage))
    worst = max(st.stages, key=lambda s: s.storage - s.packed
                - (s.hi - s.lo))
    plan = st.stage_plan(worst)
    plan.xsize -= plan.storage - (worst.packed + (worst.hi - worst.lo))
    with pytest.raises(ValueError, match="past the end"):
        check_windows(plan)


def test_refactorize_reuses_stages():
    A = generate.laplacian_3d(5)
    st = StreamingCholesky(A, CFG, stage_elems=1 << 12, device="cpu")
    f1 = st.factorize(A)
    f2 = st.factorize(2.0 * A)
    assert st.stats["stages"] == len(st.stages) > 1
    np.testing.assert_allclose(f2.L.numpy(), np.sqrt(2.0) * f1.L.numpy(),
                               rtol=1e-12, atol=1e-12)


def test_host_factor_and_solves():
    """The factor of record is the host array; the host solve reads it,
    the device solve uploads it once."""
    A = generate.laplacian_3d(5)
    st = StreamingCholesky(A, CFG, stage_elems=1 << 12, device="cpu")
    f = st.factorize(A)
    assert f.L.numpy() is not None and f.host_factor() is f._Lh
    assert np.shares_memory(f.L.numpy(), f._Lh)
    b = synth_rhs(A)
    x = f.solve(b)
    assert f._uploaded is not None and scaled_residual(A, x, b) < 1e-12
    from spfx_torch.symbolic import _native
    if _native.available():
        fh = StreamingCholesky(A, Config(dtype="float64",
                                         solve_backend="host"),
                               stage_elems=1 << 12, device="cpu").factorize(A)
        assert scaled_residual(A, fh.solve(b), b) < 1e-12
        assert fh._uploaded is None


def test_streaming_refuses_rowwin():
    with pytest.raises(ValueError, match="contig"):
        StreamingCholesky(generate.laplacian_3d(4), Config(layout="rowwin"),
                          device="cpu")
