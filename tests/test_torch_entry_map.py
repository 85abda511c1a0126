"""The port's entry values through a context's map built once
(``spfx_torch.chol.factorize.EntryMap``) on the CPU: bit for bit the host
pipeline's values for Cholesky and LU, with and without the static pivot,
in float32, float64 and complex64; the same factor from either path; the
fallback to the host pipeline for another pattern, unsorted indices and a
context analysed on a matrix that is not in canonical format; and the
recorder's counters of both paths."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spfx_torch
from spfx_torch import Config
from spfx_torch.chol.factorize import entry_values
from spfx_torch.io import generate
from spfx_torch.utils import instrument

torch.set_num_threads(1)

GRID = 4
KINDS = {"chol": (False, False), "lu": (True, False),
         "lu_static_pivot": (True, True)}
DTYPES = ("float32", "float64", "complex64")


@pytest.fixture
def rec():
    """The process's recorder, emptied, and on again afterwards."""
    instrument.enable(True)
    instrument.clear()
    yield instrument
    instrument.enable(True)
    instrument.clear()


def _lower_mask(A):
    cols = np.repeat(np.arange(A.shape[1]), np.diff(A.indptr))
    return A.indices > cols


def _matrix(pattern: str, dtype: str, shuffle: bool = False):
    """A 3-D Laplacian (``lap``), the same pattern with unsymmetric values
    (``unsym``), or with an explicit zero stored below the diagonal and
    above it (``zero``); complex data for a complex dtype. ``shuffle``
    permutes the rows, so that a static pivot has rows to move back."""
    A = generate.laplacian_3d(GRID).tocsc()
    A.sort_indices()
    A = A.copy()
    if pattern in ("unsym", "zero"):
        A.data = A.data * (1.0 + 0.1 * _lower_mask(A))
    if pattern == "zero":
        k = int(np.flatnonzero(_lower_mask(A))[3])
        A.data[k] = 0.0
        A.data[int(np.flatnonzero(~_lower_mask(A) & (A.data < 0))[5])] = 0.0
    if "complex" in dtype:
        A.data = A.data * (1.0 + 0.25j * np.sign(A.data) * _lower_mask(A))
    if shuffle:
        q = np.random.default_rng(7).permutation(A.shape[0])
        A = sp.csc_matrix(A[q])
        A.sort_indices()
    assert A.has_canonical_format
    return A


def _context(kind: str, A, dtype: str = "float64"):
    lu, pivot = KINDS[kind]
    cfg = Config(dtype=dtype, static_pivot=pivot)
    return (spfx_torch.LU if lu else spfx_torch.Cholesky)(A, cfg,
                                                          device="cpu")


def _host_path(ctx, A) -> tuple:
    """Today's host pipeline through the context: the map taken away."""
    emap, ctx._entry_map = ctx._entry_map, None
    try:
        out = ctx.entry_values(A)
    finally:
        ctx._entry_map = emap
    return out if isinstance(out, tuple) else (out,)


def _values(ctx, A) -> tuple:
    out = ctx.entry_values(A)
    return out if isinstance(out, tuple) else (out,)


def _same_bits(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.device == w.device
        assert g.shape == w.shape and g.is_contiguous()
        assert g.numpy().tobytes() == w.numpy().tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pattern", ["lap", "unsym", "zero"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_mapped_values_are_the_host_pipelines_bit_for_bit(
        rec, kind, pattern, dtype):
    pivot = KINDS[kind][1]
    A = _matrix(pattern, dtype, shuffle=pivot)
    ctx = _context(kind, A, dtype)
    assert ctx._entry_map is not None
    if pivot:
        assert not np.array_equal(ctx.row_perm, np.arange(A.shape[0]))
    # other values on the same pattern, as a refactorization brings them
    B = A.copy()
    B.data = B.data * np.linspace(0.5, 2.0, B.nnz)
    for M in (A, B):
        _same_bits(_values(ctx, M), _host_path(ctx, M))
    c = rec.snapshot()["counters"]
    assert c["entry_mapped"] == 2 and c["entry_fallback"] == 2


@pytest.mark.parametrize("kind", list(KINDS))
def test_factor_from_the_map_is_the_host_pipelines(rec, kind):
    pivot = KINDS[kind][1]
    A = _matrix("unsym" if KINDS[kind][0] else "lap", "float64",
                shuffle=pivot)
    ctx = _context(kind, A)
    mapped = ctx.factorize(A)
    ctx._entry_map, emap = None, ctx._entry_map
    host = ctx.factorize(A)
    ctx._entry_map = emap
    arrays = ("Lx", "Ux") if KINDS[kind][0] else ("L",)
    for name in arrays:
        assert torch.equal(getattr(mapped, name), getattr(host, name))
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    x = mapped.solve(b)
    assert np.abs(A @ x - b).max() < 1e-10 * np.abs(b).max()


def _unsorted(A):
    """A with the indices of its widest column reversed (the values with
    them): the same matrix, not in canonical format."""
    B = A.copy()
    j = int(np.argmax(np.diff(B.indptr)))
    lo, hi = B.indptr[j], B.indptr[j + 1]
    B.indices[lo:hi] = B.indices[lo:hi][::-1].copy()
    B.data[lo:hi] = B.data[lo:hi][::-1].copy()
    B.has_sorted_indices = False
    assert not B.has_canonical_format
    return B


def _other_pattern(A):
    """A with one more entry on each side of the diagonal."""
    n = A.shape[0]
    E = sp.csc_matrix(([0.5, 0.5], ([0, n - 1], [n - 1, 0])), shape=(n, n))
    B = sp.csc_matrix(A + E)
    assert B.nnz == A.nnz + 2
    return B


@pytest.mark.parametrize("kind", list(KINDS))
def test_other_patterns_take_the_host_pipeline(rec, kind):
    pivot = KINDS[kind][1]
    A = _matrix("unsym", "float64", shuffle=pivot)
    ctx = _context(kind, A)
    for M in (_other_pattern(A), _unsorted(A)):
        rec.clear()
        got = _values(ctx, M)
        want = entry_values(ctx.sym, ctx._pivot_rows(M) if KINDS[kind][0]
                            else M, "float64", "cpu", lu=KINDS[kind][0])
        _same_bits(got, want)
        c = rec.snapshot()["counters"]
        assert c["entry_fallback"] == 1 and "entry_mapped" not in c
    # unsorted indices give the sorted matrix's values
    _same_bits(_values(ctx, _unsorted(A)), _values(ctx, A))


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_context_on_a_non_canonical_matrix_has_no_map(rec, kind):
    pivot = KINDS[kind][1]
    A = _matrix("unsym" if KINDS[kind][0] else "lap", "float64",
                shuffle=pivot)
    ctx = _context(kind, _unsorted(A))
    assert ctx._entry_map is None
    rec.clear()
    for M in (A, _unsorted(A)):
        got = _values(ctx, M)
        want = entry_values(ctx.sym, ctx._pivot_rows(M) if KINDS[kind][0]
                            else M, "float64", "cpu", lu=KINDS[kind][0])
        _same_bits(got, want)
    f = ctx.factorize(A)
    c = rec.snapshot()["counters"]
    assert c["entry_fallback"] == 3 and "entry_mapped" not in c
    b = np.ones(A.shape[0])
    assert np.abs(A @ f.solve(b) - b).max() < 1e-10


def test_duplicates_build_no_map(rec):
    A = _matrix("lap", "float64")
    # the first entry of column 0 stored twice, in two halves
    data = np.insert(A.data, 0, A.data[0] / 2)
    data[1] /= 2
    indptr = A.indptr.copy()
    indptr[1:] += 1
    D = sp.csc_matrix((data, np.insert(A.indices, 0, A.indices[0]), indptr),
                      shape=A.shape)
    assert D.nnz == A.nnz + 1 and not D.has_canonical_format
    ctx = _context("chol", D)
    assert ctx._entry_map is None
    for M in (A, D):
        _same_bits(_values(ctx, M),
                   entry_values(ctx.sym, M, "float64", "cpu"))
    assert rec.snapshot()["counters"]["entry_fallback"] == 2


def test_lu_rows_unpermuted_take_the_host_pipeline(rec):
    A = _matrix("unsym", "float64", shuffle=True)
    ctx = _context("lu_static_pivot", A)
    got = ctx.entry_values(A, permute_rows=False)
    _same_bits(got, entry_values(ctx.sym, A, "float64", "cpu", lu=True))
    c = rec.snapshot()["counters"]
    assert c["entry_fallback"] == 1 and "entry_mapped" not in c


@pytest.mark.parametrize("kind", list(KINDS))
def test_same_pattern_requests_count_one_mapped_each(rec, kind):
    pivot = KINDS[kind][1]
    A = _matrix("unsym" if KINDS[kind][0] else "lap", "float32",
                shuffle=pivot)
    ctx = _context(kind, A, "float32")
    # fresh matrix objects: the analysed arrays themselves, then copies
    mats = [sp.csc_matrix((A.data * s, A.indices, A.indptr), shape=A.shape)
            for s in (1.0, 1.5)]
    mats.append(sp.csc_matrix((A.data * 2.0, A.indices.copy(),
                               A.indptr.copy()), shape=A.shape))
    for M in mats:
        ctx.factorize(M)
    snap = rec.snapshot()
    reqs = [r for r in snap["requests"] if r["kind"] == "spfx.factorize"]
    assert len(reqs) == 3
    for r in reqs:
        assert r["counters"]["entry_mapped"] == 1
        assert "entry_fallback" not in r["counters"]
        # the bytes copied are A's values, once
        assert r["counters"]["entry_bytes"] == A.nnz * 4
        assert sum(s["name"] == "spfx.entry.permute" for s in r["spans"]) \
            == 1
    assert snap["counters"]["entry_mapped"] == 3
    assert "entry_fallback" not in snap["counters"]


@pytest.mark.parametrize("kind", list(KINDS))
def test_the_map_is_a_plan_constant(rec, kind):
    lu, pivot = KINDS[kind]
    A = _matrix("unsym" if lu else "lap", "float64", shuffle=pivot)
    ctx = _context(kind, A)
    emap = ctx._entry_map
    # built in the plan's set-up span, no span of its own
    assert [s["name"] for s in rec.snapshot()["setup"]] == ["spfx.analyze",
                                                            "spfx.plan"]
    assert all(s.dtype == torch.int64 and s.device == torch.device("cpu")
               for s in emap.src)
    assert emap.indptr is ctx.A.indptr and emap.indices is ctx.A.indices
    src = np.concatenate([s.numpy() for s in emap.src])
    if lu:      # the lower and strict upper arrays take every entry once
        assert np.array_equal(np.sort(src), np.arange(A.nnz))
    else:       # the lower triangle's entries, each once
        assert len(src) == (A.nnz + A.shape[0]) // 2
        assert len(np.unique(src)) == len(src)
