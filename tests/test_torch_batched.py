"""The port's batched dense kernels against the JAX package on the CPU, with
the same seeded numpy inputs: the plain ``syrk_gemm_batched`` and
``cholesky_small_batched`` against the Pallas kernels in interpret mode,
and the panel bench ``spfx_torch.bench.panels`` at a small batch."""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from spfx.kernels import pallas_blocks

from spfx_torch.bench import panels
from spfx_torch.kernels import chol_small, syrk_gemm
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


# --------------------------------------------------------------------------
# syrk_gemm_batched
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-13)])
@pytest.mark.parametrize("batch,n,m,k,slab", [(128, 16, 16, 8, 32),
                                              (64, 16, 12, 8, 32),
                                              (16, 64, 64, 32, 8),
                                              (8, 70, 33, 40, 4),
                                              (4, 1, 1, 1, 2)])
def test_syrk_gemm_matches_pallas(batch, n, m, k, slab, dtype, tol):
    """Relative to each output's largest entry: both sides are k-term dot
    products summed in their own orders."""
    npd, td = DTYPES[dtype]
    rng = np.random.default_rng(batch + m)
    A = rng.standard_normal((batch, n, k)).astype(npd)
    B = rng.standard_normal((batch, m, k)).astype(npd)
    Sj, Gj = (np.asarray(x) for x in pallas_blocks.syrk_gemm_batched(
        jnp.asarray(A), jnp.asarray(B), slab=slab))
    S, G = syrk_gemm.syrk_gemm_batched(torch.from_numpy(A),
                                       torch.from_numpy(B))
    assert S.shape == (batch, n, n) and G.shape == (batch, m, n)
    assert S.dtype == G.dtype == td
    for got, ref in ((S, Sj), (G, Gj)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("n,m,k,itemsize,ptrs,want", [
    (64, 64, 32, 4, (0, 256), "bulk"),       # the panel bench's shape
    (64, 64, 32, 8, (0, 256), "bulk"),       # f64 too
    (4, 1, 4, 4, (16, 32), "bulk"),          # the smallest f32 item
    (2, 126, 2, 8, (16, 32), "bulk"),        # n + m = 128, f64 vectors
    (64, 64, 30, 8, (0, 0), "bulk"),         # k a multiple of two f64
    (64, 64, 30, 4, (0, 0), "general"),      # ... but not of four f32
    (62, 2, 32, 4, (0, 0), "general"),       # n not a multiple of four
    (68, 4, 32, 4, (0, 0), "general"),       # n > 64
    (64, 65, 32, 4, (0, 0), "general"),      # n + m > 128
    (64, 64, 36, 4, (0, 0), "general"),      # k > 32
    (64, 64, 32, 4, (4, 0), "general"),      # A not 16-byte aligned
    (64, 64, 32, 4, (0, 8), "general"),      # B not 16-byte aligned
    (70, 33, 40, 4, (0, 0), "general"),
    (1, 1, 1, 8, (0, 0), "general"),
    (128, 200, 17, 4, (0, 0), "general"),
])
def test_syrk_gemm_path(n, m, k, itemsize, ptrs, want):
    """Which shapes, types and alignments take the bulk path (streamed by
    bulk copies: n <= 64, n + m <= 128, k <= 32, n and k multiples of a
    16-byte vector, A and B 16-byte aligned) and which the general one."""
    assert syrk_gemm.path(n, m, k, itemsize, *ptrs) == want


def test_syrk_gemm_rejects_bad_input():
    A = torch.zeros(4, 8, 3)
    with pytest.raises(TypeError):
        syrk_gemm.syrk_gemm_batched(A.half(), A.half())
    with pytest.raises(TypeError):
        syrk_gemm.syrk_gemm_batched(A, A.double())
    with pytest.raises(ValueError, match="batch"):
        syrk_gemm.syrk_gemm_batched(A, torch.zeros(4, 8, 5))
    with pytest.raises(ValueError, match=">= 1"):
        syrk_gemm.syrk_gemm_batched(A, torch.zeros(4, 0, 3))
    with pytest.raises(ValueError, match="contiguous"):
        syrk_gemm.syrk_gemm_batched(A, torch.zeros(4, 3, 8).transpose(1, 2))


# --------------------------------------------------------------------------
# cholesky_small_batched
# --------------------------------------------------------------------------

def _spd_blocks(batch, c, seed, junk=0.0):
    """Seeded SPD blocks, ``junk`` times normals added above the
    diagonal."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((batch, c, c))
    D = X @ np.swapaxes(X, 1, 2) + 3 * np.eye(c)
    return D + np.triu(rng.standard_normal((batch, c, c)) * junk, 1)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-13)])
@pytest.mark.parametrize("batch,c,slab", [(64, 8, 16), (32, 32, 16)])
def test_cholesky_small_matches_pallas(batch, c, slab, dtype, tol):
    """Relative to the factor's largest entry: the same column recurrence
    on both sides. Junk above the diagonal changes neither side."""
    npd, td = DTYPES[dtype]
    D = _spd_blocks(batch, c, c).astype(npd)
    Dj = _spd_blocks(batch, c, c, junk=1e3).astype(npd)
    Lj = np.asarray(pallas_blocks.cholesky_small_batched(jnp.asarray(D),
                                                         slab=slab))
    Lj2 = np.asarray(pallas_blocks.cholesky_small_batched(jnp.asarray(Dj),
                                                          slab=slab))
    L = chol_small.cholesky_small_batched(torch.from_numpy(D))
    L2 = chol_small.cholesky_small_batched(torch.from_numpy(Dj))
    assert L.dtype == td and L.shape == (batch, c, c)
    np.testing.assert_array_equal(Lj2, Lj)
    assert torch.equal(L2, L)
    np.testing.assert_allclose(L.numpy(), Lj, rtol=0,
                               atol=tol * np.abs(Lj).max())
    assert (np.triu(L.numpy(), 1) == 0).all()
    Dd = D.astype(np.float64)
    Ld = L.numpy().astype(np.float64)
    np.testing.assert_allclose(Ld @ np.swapaxes(Ld, 1, 2), Dd, rtol=0,
                               atol=10 * tol * np.abs(Dd).max())


@pytest.mark.parametrize("batch", [1, 3, 64])
def test_cholesky_small_every_c_matches_torch(batch):
    """The plain version against torch.linalg.cholesky at every c from 1
    to 32, f64, within 1e-12 of max |L|: the same factor, sums in other
    orders."""
    for c in range(1, 33):
        D = torch.from_numpy(_spd_blocks(batch, c, 100 + c))
        L = chol_small.cholesky_small_batched(D)
        ref = torch.linalg.cholesky(D)
        assert L.shape == (batch, c, c) and L.dtype == torch.float64
        tol = 1e-12 * float(ref.abs().max())
        assert float((L - ref).abs().max()) <= tol, c


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cholesky_small_nan_inf_junk(dtype):
    """NaN above the diagonal of half the matrices and +Inf above that of
    a quarter, at (32, 8): the port's L is bit for bit its L of the clean
    input, and within the tolerances of test_cholesky_small_matches_pallas
    of the Pallas kernel's L of the clean input (slab 16). The Pallas
    kernel itself pulls column j out with a one-hot contraction over whole
    rows, so the junk reaches its L (NaN * 0 is NaN) in exactly the
    matrices that hold NaN or Inf: asserted too, so that the port's
    stronger contract stays a recorded difference."""
    npd, td = DTYPES[dtype]
    tol = 1e-5 if dtype == "float32" else 1e-13
    batch, c = 32, 8
    D = _spd_blocks(batch, c, 7).astype(npd)
    Dj = D.copy()
    up = np.triu(np.ones((c, c), bool), 1)
    Dj[0::2][:, up] = np.nan
    Dj[1::4][:, up] = np.inf
    L = chol_small.cholesky_small_batched(torch.from_numpy(D))
    Lj = chol_small.cholesky_small_batched(torch.from_numpy(Dj))
    assert Lj.dtype == td
    assert torch.equal(Lj, L)
    P = np.asarray(pallas_blocks.cholesky_small_batched(jnp.asarray(D),
                                                        slab=16))
    np.testing.assert_allclose(Lj.numpy(), P, rtol=0,
                               atol=tol * np.abs(P).max())
    Pj = np.asarray(pallas_blocks.cholesky_small_batched(jnp.asarray(Dj),
                                                         slab=16))
    junk = np.zeros(batch, bool)
    junk[0::2] = junk[1::4] = True
    assert np.isnan(Pj[junk][:, ~up]).all()
    np.testing.assert_array_equal(Pj[~junk], P[~junk])


def test_cholesky_small_contract():
    """c from 1 to 32 works, a non-positive pivot gives NaN, c = 33 and a
    non-square or non-float input raise."""
    for c in (1, 7, 16):
        D = torch.from_numpy(_spd_blocks(4, c, c))
        L = chol_small.cholesky_small_batched(D)
        ref = torch.linalg.cholesky(D)
        assert torch.allclose(L, ref, rtol=0, atol=1e-12)
    D = torch.eye(4, dtype=torch.float64).repeat(2, 1, 1)
    D[1, 2, 2] = -1.0
    L = chol_small.cholesky_small_batched(D)
    assert torch.equal(L[0], torch.eye(4, dtype=torch.float64))
    assert torch.isnan(L[1, 2, 2])
    with pytest.raises(ValueError, match="c <= 32"):
        chol_small.cholesky_small_batched(torch.zeros(2, 33, 33))
    with pytest.raises(ValueError, match="batch, c, c"):
        chol_small.cholesky_small_batched(torch.zeros(2, 4, 5))
    with pytest.raises(TypeError):
        chol_small.cholesky_small_batched(torch.zeros(2, 4, 4,
                                                      dtype=torch.int32))


# --------------------------------------------------------------------------
# the panel bench
# --------------------------------------------------------------------------

def test_panel_bench_on_cpu(capsys):
    """Four finite, positive GFLOP/s at a small batch, the table on
    stderr, and the three batched strategies agree."""
    res = panels.main(device="cpu", batch=256)
    assert sorted(res) == sorted(["batched_single_call", "chunked_1024",
                                  "custom_kernel",
                                  "per_task_loop_extrapolated"])
    assert all(math.isfinite(v) and v > 0 for v in res.values())
    err = capsys.readouterr().err
    assert all(k in err for k in res) and "GFLOP/s" in err
    A, B = panels.inputs(256, "cpu")
    assert A.shape == (256, panels.N, panels.K) and A.dtype == torch.float32
    ref = panels.strategy_batched(A, B)
    for fn in (panels.strategy_chunked, panels.strategy_custom):
        for got, r in zip(fn(A, B), ref):
            torch.testing.assert_close(got, r, rtol=0,
                                       atol=1e-5 * float(r.abs().max()))
    one = panels.strategy_batched(A[:1], B[:1])
    torch.testing.assert_close(one[0], ref[0][:1], rtol=0, atol=1e-4)
    assert panels.flops(256) == 256 * (2.0 * 64 * 64 * 32
                                       + 2.0 * 64 * 64 * 32)
