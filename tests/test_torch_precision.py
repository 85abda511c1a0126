"""JAX's matmul precision "high" (bf16x3) in the port: ``matmul_precision``
and ``update_precision`` = "high" for float32 factorizations, against the
JAX package's "high" (which its CPU backend runs in full float32), and the
plain bf16x3 product ``matmul.bmm_bf16x3_plain`` against its error model.

Tolerance of a "high" factor against JAX's: 1e-4 of the array's largest
entry. Each bf16x3 product carries about 3 x 2^-16 (4.6e-5) of sum |a||b|
per entry (the dropped lo.lo term and the roundings of lo), where JAX's
full float32 carries about 2^-24 k; the factors here are of well
conditioned matrices, whose entries stay within a small factor of those
sums (measured: about 1e-6)."""

import contextlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import spfx

import spfx_torch
from spfx_torch import Config
from spfx_torch.io import generate
from spfx_torch.kernels import blocks, matmul, mega
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

HIGH_TOL = 1e-4
FIELDS = ("matmul_precision", "update_precision")
MATRICES = {"lap6": lambda: generate.laplacian_3d(6),
            "unsym": lambda: generate.random_unsym(120, density=0.04,
                                                   seed=5)}


def _names(lu):
    return ("Lx", "Ux") if lu else ("L",)


@pytest.mark.parametrize("config", [{}, dict(layout="rowwin")],
                         ids=["contig", "rowwin"])
@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_high_matches_jax(lu, field, config):
    """A float32 factor at "high" against the JAX package's at "high", and
    the refined residual <= 1e-12."""
    A = MATRICES["unsym" if lu else "lap6"]()
    kw = {field: "high", **config}
    jk = spfx.lu if lu else spfx.cholesky
    tk = spfx_torch.lu if lu else spfx_torch.cholesky
    fj = jk(A, spfx.Config(dtype="float32", **kw))
    ft = tk(A, Config(dtype="float32", **kw), device="cpu")
    for nm in _names(lu):
        want = np.asarray(getattr(fj, nm))
        got = getattr(ft, nm).numpy()
        assert np.abs(got - want).max() <= HIGH_TOL * np.abs(want).max()
    b = spfx_torch.synth_rhs(A)
    assert spfx_torch.scaled_residual(A, ft.solve(b), b) <= 1e-12


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_high_goes_through_bf16x3(monkeypatch, lu):
    """Under update_precision="high" every update product goes through
    bmm_bf16x3 (one per UT step, LU's two), and nothing else; under
    matmul_precision="high" the panel products do too."""
    calls = []
    real = matmul.bmm_bf16x3

    def spy(a, b):
        calls.append(mega.matmul.mode())
        return real(a, b)

    monkeypatch.setattr(matmul, "bmm_bf16x3", spy)
    A = generate.laplacian_3d(6)
    kind = spfx_torch.LU if lu else spfx_torch.Cholesky
    ctx = kind(A, Config(dtype="float32", update_precision="high"),
               device="cpu")
    ctx.factorize(A)
    ut = sum(len(lp.updates) for lp in ctx.plan.levels)
    assert len(calls) == ut * (2 if lu else 1) and ut
    calls.clear()
    ctx = kind(A, Config(dtype="float32", matmul_precision="high"),
               device="cpu")
    ctx.factorize(A)
    assert len(calls) > ut * (2 if lu else 1)
    assert matmul.mode() == "highest"


def test_high_leaves_f64_and_complex_alone(monkeypatch):
    """"high" changes float32 products only: float64 and complex factors
    are the default precision's bit for bit, and bmm_bf16x3 is never
    called."""
    monkeypatch.setattr(matmul, "bmm_bf16x3", lambda a, b: 1 / 0)
    A = generate.laplacian_3d(5)
    for dtype in ("float64", "complex64"):
        a = spfx_torch.cholesky(A, Config(dtype=dtype), device="cpu")
        b = spfx_torch.cholesky(A, Config(dtype=dtype,
                                          matmul_precision="high"),
                                device="cpu")
        assert torch.equal(a.L, b.L)


def _operands(batch, m, n, k, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((batch, m, k)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((batch, k, n)).astype(
        np.float32))
    # values that span 2^20 in scale, as a factor's do
    a = a * torch.exp2(torch.from_numpy(rng.integers(-10, 10, (batch, m, 1))
                                        .astype(np.float32)))
    return a, b


@pytest.mark.parametrize("shape", [(3, 70, 33, 40), (2, 64, 16, 256),
                                   (5, 1, 1, 1), (4, 33, 9, 0)])
def test_bf16x3_plain_error_model(shape):
    """|bf16x3 - exact| <= (3 x 2^-16 + k 2^-22) sum |a||b| per entry, and
    its largest error is below one bf16 pass's on the same inputs."""
    batch, m, n, k = shape
    a, b = _operands(batch, m, n, k, sum(shape))
    got = matmul.bmm_bf16x3_plain(a, b).double()
    exact = torch.bmm(a.double(), b.double())
    scale = torch.bmm(a.abs().double(), b.abs().double())
    err = (got - exact).abs()
    assert bool((err <= (3 * 2.0 ** -16 + k * 2.0 ** -22) * scale).all())
    one = torch.bmm(a.bfloat16().double(), b.bfloat16().double())
    if k:
        assert float(err.max()) < float((one - exact).abs().max())
    # the transposed views the walks pass give the same product
    bt = b.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(matmul.bmm_bf16x3(a, bt), matmul.bmm_bf16x3(a, b))


def test_bmm_dispatch():
    """matmul.bmm is torch.bmm outside "high", and for float64 and complex
    operands inside it; float32 inside "high" is the bf16x3 product."""
    a, b = _operands(2, 9, 7, 33, 1)
    assert torch.equal(matmul.bmm(a, b), torch.bmm(a, b))
    with mega.matmul_precision("high"):
        assert torch.equal(matmul.bmm(a, b), matmul.bmm_bf16x3_plain(a, b))
        assert torch.equal(matmul.bmm(a.double(), b.double()),
                           torch.bmm(a.double(), b.double()))
        ac, bc = a.to(torch.complex64), b.to(torch.complex64)
        assert torch.equal(matmul.bmm(ac, bc), torch.bmm(ac, bc))
    with pytest.raises(TypeError):
        matmul.bmm_bf16x3(a.double(), b.double())
    with pytest.raises(ValueError):
        matmul.bmm_bf16x3(a, b[:, :5])


# (m, k) of the 48^3 plan's UT products, each class once
UT_CLASSES = ((64, 32), (144, 64), (160, 32), (136, 128), (48, 64),
              (132, 256), (40, 128), (36, 256))


def _ut_operands(batch, m, k, n):
    """A UT product's operands as the update step passes them: G a fresh
    (batch, m, k) tensor, H^T the transposed view of a fresh (batch, n,
    k) H."""
    return (torch.zeros(batch, m, k),
            torch.zeros(batch, n, k).transpose(1, 2))


@pytest.mark.parametrize("mk", UT_CLASSES, ids=str)
@pytest.mark.parametrize("n", [12, 64, 80, 260, 288])
def test_ut_products_take_the_fast_path(mk, n):
    """Every UT product class's G and H^T are read as they lie."""
    assert matmul.path(*_ut_operands(16, *mk, n)) == "fast"


def _transposed_a():
    G, Ht = _ut_operands(4, 64, 32, 64)
    return G.transpose(1, 2).contiguous().transpose(1, 2), Ht


def _offset_a():
    G, Ht = _ut_operands(4, 64, 32, 64)
    return torch.zeros(G.numel() + 1)[1:].view(G.shape), Ht


def _k_strided_b():
    G, Ht = _ut_operands(4, 64, 32, 64)
    return G, Ht.contiguous()


def _odd_row_stride():
    G, Ht = _ut_operands(4, 64, 34, 64)
    return G[:, :, :33], Ht[:, :33, :]


OTHER_VIEWS = pytest.mark.parametrize(
    "make", [_transposed_a, _offset_a, _k_strided_b, _odd_row_stride],
    ids=["transposed A", "A offset by one value", "B with k-stride != 1",
         "odd row strides"])


@OTHER_VIEWS
def test_other_views_are_copied_first(make):
    """A transposed A, a view one value off its allocation, a B whose
    k-stride is not 1 and rows whose stride is not a multiple of 4 values
    are copied before the kernel reads them; the choice reads shapes,
    strides and alignment alone, so it is the same on the CPU and on the
    card."""
    assert matmul.path(*make()) == "copy"


@OTHER_VIEWS
def test_one_copy_brings_a_view_to_the_kernels_layout(make):
    """matmul.fast_layout: an operand that fits is passed as it lies, any
    other is copied once, k unit-stride and rows padded to 4 values, and
    then the pair is read as it lies, with the same values."""
    a, b = make()
    gen = torch.Generator().manual_seed(15)
    a.copy_(torch.randn(a.shape, generator=gen))
    b.copy_(torch.randn(b.shape, generator=gen))
    fa = matmul.fast_layout(a)
    fb = matmul.fast_layout(b.transpose(1, 2)).transpose(1, 2)
    assert matmul.path(fa, fb) == "fast"
    assert torch.equal(fa, a) and torch.equal(fb, b)
    assert (fa.data_ptr() == a.data_ptr()) == matmul.fits(a)
    assert (fb.data_ptr() == b.data_ptr()) == matmul.fits(b.transpose(1, 2))


@pytest.mark.parametrize("batch", [1, 16, 128, 1024])
@pytest.mark.parametrize("mk", UT_CLASSES, ids=str)
@pytest.mark.parametrize("n", [12, 64, 80, 260, 288])
def test_fast_tile_fits_the_product(batch, mk, n):
    """The kernel's tile at every UT class, n and batch: one row tile of
    m rounded up to 16; the work within a warp's columns of the tensor
    cores' grain (m and n up to 16 and 8, k up to 16), and under 15% above
    m n k wherever that grain allows it (m >= 48 and n >= 64: every class
    but the two narrowest, at all but the thinnest n); the 64 x 64 tiles
    of the earlier any-strides kernel padded the largest product (132 x
    260) by 79%."""
    m, k = mk
    tm, tn = matmul.fast_tile(batch, m, n)
    assert tm == -(-m // 16) * 16 and tn in (32, 64)
    work = matmul.fast_work(batch, m, n, k)
    grain = batch * tm * -(-n // 8) * 8 * -(-k // 16) * 16
    assert grain <= work <= grain + batch * tm * (tn // 4 - 8) * k
    if m >= 48 and n >= 64:
        assert work / (batch * m * n * k) - 1 < 0.15


@pytest.mark.parametrize("m", [0, 1])
def test_fast_tile_of_empty_and_single_rows(m):
    """A product with no rows (the blocked panel path's last column block
    leaves M[:, cp:] empty) or one row still has a tile of one fragment."""
    assert matmul.fast_tile(3, m, 5) == (16, 32)


@pytest.mark.parametrize("m", [161, 200, 300, 1000])
def test_fast_tile_of_tall_products(m):
    """Taller than one tile: row tiles of one multiple of 16 up to 160,
    padding m within 10% of m rounded up to 16."""
    tm, _ = matmul.fast_tile(4, m, 64)
    assert tm % 16 == 0 and tm <= matmul.MAX_TILE_M
    assert -(-m // tm) * tm <= 1.1 * (-(-m // 16) * 16)


@pytest.mark.parametrize("name", ["high", "highest", "default"])
def test_precision_restores_torch_state(name):
    """The walks switch torch's float32 matmul mode and the product mode
    only inside their contexts; update_precision="high" wraps the updates
    only, and the global state is as it was afterwards."""
    before = (torch.get_float32_matmul_precision(),
              torch.backends.cuda.matmul.allow_tf32, matmul.mode())
    with mega.matmul_precision(name):
        assert matmul.mode() == ("high" if name == "high"
                                 else mega._PRECISION[name])
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32, matmul.mode()) == before
    A = generate.laplacian_3d(4)
    spfx_torch.cholesky(A, Config(dtype="float32", update_precision=name),
                        device="cpu")
    spfx_torch.lu(A, Config(dtype="float32", matmul_precision=name),
                  device="cpu")
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32, matmul.mode()) == before
    ctx = mega.update_precision(Config(update_precision=name))
    assert (ctx is contextlib.nullcontext) == (name == "highest")


def test_blocked_panel_high_is_close():
    """The blocked panel path's deltas at "high" against full float32 on
    the same blocks, within the tolerance of the factor tests."""
    rng = np.random.default_rng(3)
    B, cp, rbp = 4, 64, 40
    X = rng.standard_normal((B, cp, cp))
    D = torch.from_numpy((X @ X.transpose(0, 2, 1) + cp * np.eye(cp))
                         .astype(np.float32))
    Bl = torch.from_numpy(rng.standard_normal((B, rbp, cp)).astype(
        np.float32))
    w = torch.tensor([cp, cp - 5, 33, 1], dtype=torch.int32)
    nb = torch.tensor([rbp, 3, rbp - 1, 0], dtype=torch.int32)
    ref = blocks._chol_deltas_blocked(D, Bl, w, nb, cp, rbp)
    with mega.matmul_precision("high"):
        got = blocks._chol_deltas_blocked(D, Bl, w, nb, cp, rbp)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= HIGH_TOL * float(r.abs().max())


# the seeded float32 product of the "default" precision's repair: (512, 64)
# @ (64, 3000), whose error against float64 is 0.107 in one bf16 pass and
# 1.45e-5 in full float32
PRODUCT = (512, 64, 3000)


@pytest.mark.parametrize("name", ["highest", "float32", "default",
                                  "bfloat16", "high"])
def test_cpu_products_keep_float32(name):
    """On the CPU every JAX precision but "high" runs float32 products in
    full float32 (JAX's CPU backend does), within 1e-4 of float64: torch's
    process-wide "medium" would send them through oneDNN's bf16. "high"
    stays within the bf16x3 error model. torch's own matmul inside the
    context is full float32 too."""
    m, k, n = PRODUCT
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    exact = a.double() @ b.double()
    with mega.matmul_precision(name):
        got = matmul.bmm(a[None], b[None])[0].double()
        plain = (a @ b).double()
    err = (got - exact).abs()
    if name == "high":
        scale = a.abs().double() @ b.abs().double()
        assert bool((err <= (3 * 2.0 ** -16 + k * 2.0 ** -22) * scale).all())
    else:
        assert float(err.max()) <= 1e-4
    assert float((plain - exact).abs().max()) <= 1e-4


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
def test_default_precision_matches_jax(lu):
    """Config(matmul_precision="default") float32 factors at laplacian_3d(6)
    against the JAX package's, within 1e-5 of each array's largest entry
    (the other float32 parity tests' tolerance)."""
    A = generate.laplacian_3d(6)
    jk = spfx.lu if lu else spfx.cholesky
    tk = spfx_torch.lu if lu else spfx_torch.cholesky
    kw = dict(dtype="float32", matmul_precision="default")
    fj = jk(A, spfx.Config(**kw))
    ft = tk(A, Config(**kw), device="cpu")
    for nm in _names(lu):
        want = np.asarray(getattr(fj, nm))
        got = getattr(ft, nm).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
