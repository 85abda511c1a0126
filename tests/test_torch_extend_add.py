"""The port's extend-add on the CPU: the plain ``extend_add_rows`` and its
LU twin ``extend_add_rows2`` against the JAX package's Pallas kernel in
interpret mode, with the same seeded numpy inputs, the choice between the
kernel's 16-byte and single-value paths, the plan's row table against its
windowed one-hot group tables, and the host check of the extend-add
tables. The UT steps through it are held against JAX's in
test_torch_kernels.py and test_torch_lu.py."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from spfx.kernels import pallas_blocks

from spfx_torch.chol.factorize import check_windows
from spfx_torch.io import generate
from spfx_torch.kernels import extend_add
from spfx_torch.plan.schedule import ALIGN, EA_G, build_plan
from spfx_torch.symbolic.analyze import analyze
from spfx_torch.utils.config import Config
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}
# relative to the slab's largest entry: the kernel subtracts row by row,
# the Pallas kernel too, in the same order on the CPU; f32 leaves room for
# the card's atomics, which take repeated rows in any order
TOL = {"float32": 1e-6, "float64": 1e-14}


def _spd(n, seed=0):
    B = sp.random(n, n, density=0.02, random_state=seed).tocsc()
    return sp.csc_matrix(B @ B.T + sp.diags(np.full(n, n * 0.1)))


MATRICES = {"lap6": lambda: generate.laplacian_3d(6),
            "spd300": lambda: _spd(300)}


# --------------------------------------------------------------------------
# extend_add_rows
# --------------------------------------------------------------------------

def _inputs(Rs, csp, total, npd, seed):
    """A seeded slab, update rows and targets in [-5, Rs), with repeats."""
    rng = np.random.default_rng(seed)
    slab = rng.standard_normal((Rs, csp)).astype(npd)
    Ef = rng.standard_normal((total, csp)).astype(npd)
    rows = rng.integers(-5, Rs, total).astype(np.int32)
    return slab, rows, Ef


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Rs,csp,total", [(40, 24, 300), (64, 128, 1000),
                                          (8, 3, 5)])
def test_extend_add_rows_matches_pallas(Rs, csp, total, dtype):
    npd, _ = DTYPES[dtype]
    slab, rows, Ef = _inputs(Rs, csp, total, npd, Rs + csp + total)
    ref = np.asarray(pallas_blocks.extend_add_rows(
        jnp.asarray(slab), jnp.asarray(rows), jnp.asarray(Ef)))
    out = extend_add.extend_add_rows(torch.from_numpy(slab.copy()),
                                     torch.from_numpy(rows),
                                     torch.from_numpy(Ef))
    assert out.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=TOL[dtype] * np.abs(ref).max())
    # the slab rows no live row names are untouched
    hit = np.zeros(Rs, bool)
    hit[rows[rows >= 0]] = True
    np.testing.assert_array_equal(out.numpy()[~hit], slab[~hit])


def test_extend_add_rows_in_place_on_a_view():
    """The slab is a view of a flat array: the array changes where the view
    lies, nowhere else, and the call returns the view itself."""
    slab, rows, Ef = _inputs(16, 8, 50, np.float64, 3)
    flat = torch.zeros(300, dtype=torch.float64)
    flat[20:20 + slab.size] = torch.from_numpy(slab.ravel())
    view = flat[20:20 + slab.size].view(16, 8)
    out = extend_add.extend_add_rows(view, torch.from_numpy(rows),
                                     torch.from_numpy(Ef))
    assert out is view
    ref = slab.copy()
    for i, t in enumerate(rows):
        if t >= 0:
            ref[t] -= Ef[i]
    np.testing.assert_allclose(flat[20:20 + slab.size].numpy(), ref.ravel(),
                               rtol=0, atol=1e-14)
    assert (flat[:20] == 0).all() and (flat[20 + slab.size:] == 0).all()


def test_extend_add_rows_all_dropped_and_one_target():
    """Every row dropped leaves the slab as it was, bit for bit; every row
    on one slab row subtracts their sum there (integer values: exact in
    any order)."""
    slab, _, Ef = _inputs(10, 6, 40, np.float64, 4)
    s = torch.from_numpy(slab.copy())
    extend_add.extend_add_rows(s, torch.full((40,), -1, dtype=torch.int32),
                               torch.from_numpy(Ef))
    assert torch.equal(s, torch.from_numpy(slab))
    Ei = np.round(Ef * 4)
    s = torch.from_numpy(np.round(slab * 4))
    extend_add.extend_add_rows(s, torch.full((40,), 7, dtype=torch.int32),
                               torch.from_numpy(Ei))
    ref = np.round(slab * 4)
    ref[7] -= Ei.sum(0)
    np.testing.assert_array_equal(s.numpy(), ref)


def test_extend_add_rows_rejects_bad_input():
    slab = torch.zeros(4, 3, dtype=torch.float64)
    E = torch.ones(2, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="past the slab"):
        extend_add.extend_add_rows(slab, torch.tensor([0, 4],
                                                      dtype=torch.int32), E)
    ok = torch.tensor([0, 1], dtype=torch.int32)
    for bad in (torch.float16, torch.int32):
        with pytest.raises(TypeError):
            extend_add.extend_add_rows(slab.to(bad), ok, E.to(bad))
    with pytest.raises(TypeError):
        extend_add.extend_add_rows(slab, ok, E.float())
    with pytest.raises(ValueError, match="int32"):
        extend_add.extend_add_rows(slab, ok.long(), E)
    with pytest.raises(ValueError, match="int32"):
        extend_add.extend_add_rows(slab, ok[:1], E)
    with pytest.raises(ValueError, match="csp"):
        extend_add.extend_add_rows(slab, ok, torch.ones(2, 4,
                                                        dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        extend_add.extend_add_rows(torch.zeros(3, 4, dtype=torch.float64).T,
                                   ok, E)
    assert torch.equal(slab, torch.zeros(4, 3, dtype=torch.float64))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Rs,csp,total", [(40, 24, 300), (64, 33, 1000),
                                          (8, 3, 5)])
def test_extend_add_rows2_matches_pallas(Rs, csp, total, dtype):
    """The twin against the Pallas extend_add_rows on each slab, with one
    row table (repeated targets and dropped rows), at TOL."""
    npd, _ = DTYPES[dtype]
    sl, rows, EL = _inputs(Rs, csp, total, npd, 2 * Rs + csp + total)
    su, _, EU = _inputs(Rs, csp, total, npd, 3 * Rs + csp + total)
    outs = extend_add.extend_add_rows2(
        torch.from_numpy(sl.copy()), torch.from_numpy(su.copy()),
        torch.from_numpy(rows), torch.from_numpy(EL), torch.from_numpy(EU))
    for out, slab, E in zip(outs, (sl, su), (EL, EU)):
        ref = np.asarray(pallas_blocks.extend_add_rows(
            jnp.asarray(slab), jnp.asarray(rows), jnp.asarray(E)))
        assert out.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=TOL[dtype] * np.abs(ref).max())


def test_extend_add_rows2_rejects_bad_input():
    """Mismatched slabs, E shapes, dtypes and devices raise before any
    slab changes, as does a live row past the slabs."""
    f64 = dict(dtype=torch.float64)
    sl, su = torch.zeros(4, 3, **f64), torch.zeros(4, 3, **f64)
    E = torch.ones(2, 3, **f64)
    ok = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="each pair must match"):
        extend_add.extend_add_rows2(sl, torch.zeros(5, 3, **f64), ok, E, E)
    with pytest.raises(ValueError, match="each pair must match"):
        extend_add.extend_add_rows2(sl, torch.zeros(4, 2, **f64), ok, E,
                                    torch.ones(2, 2, **f64))
    with pytest.raises(ValueError, match="csp"):
        extend_add.extend_add_rows2(sl, su, ok, E, torch.ones(2, 4, **f64))
    with pytest.raises(TypeError):
        extend_add.extend_add_rows2(sl, su.float(), ok, E, E.float())
    with pytest.raises(TypeError):
        extend_add.extend_add_rows2(sl, su, ok, E, E.float())
    with pytest.raises(ValueError, match="on meta"):
        extend_add.extend_add_rows2(sl, su.to("meta"), ok, E, E.to("meta"))
    with pytest.raises(ValueError, match="Ef on meta"):
        extend_add.extend_add_rows2(sl, su, ok, E, E.to("meta"))
    with pytest.raises(ValueError, match="past the slab"):
        extend_add.extend_add_rows2(sl, su, torch.tensor([0, 4],
                                                         dtype=torch.int32),
                                    E, E)
    assert not sl.any() and not su.any()


@pytest.mark.parametrize("csp,item,ptrs,want", [
    (256, 4, (0, 4096), True),       # the plan's widths, aligned
    (32, 4, (512, 16), True),
    (2, 8, (0, 16, 32, 48), True),   # f64: one vector a row
    (33, 4, (0, 4096), False),       # a row is no whole number of vectors
    (6, 4, (0, 16), False),
    (3, 8, (0, 16), False),
    (256, 4, (0, 4), False),         # E one value past a boundary
    (256, 8, (8, 0, 16, 32), False),
])
def test_vector_path(csp, item, ptrs, want):
    """The kernel's 16-byte path needs rows of whole 16-byte vectors and
    16-byte aligned slabs and E."""
    assert extend_add.vector_path(csp, item, ptrs) is want


# --------------------------------------------------------------------------
# the plan's row table
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["lap6", "spd300"])
def chol_plan(request):
    """The port's plan of one matrix (float64)."""
    A = MATRICES[request.param]()
    return build_plan(analyze(A, Config(dtype="float64")), A,
                      Config(dtype="float64"))


def _ubs(plan):
    return [ub for lp in plan.levels for ub in lp.updates]


def test_row_table_pairs_are_the_group_pairs(chol_plan):
    """The live (E row, slab row) pairs of tgt_lrow are exactly the pairs
    of the ea_idx / ea_rbase / ea_rel groups, each E row once."""
    plan = chol_plan
    for ub in _ubs(plan):
        rows = ub.to("cpu")[6].numpy()
        assert rows.shape == (len(ub.kw) * (ub.mp + ALIGN // ub.kp),)
        live = np.flatnonzero(rows >= 0)
        pairs = sorted(zip(live.tolist(), rows[live].tolist()))
        rel = ub.ea_rel.reshape(-1)
        g = np.repeat(np.arange(len(ub.ea_rbase)), EA_G)
        keep = rel >= 0
        gpairs = sorted(zip(ub.ea_idx[keep].tolist(),
                            (ub.ea_rbase[g] + rel)[keep].tolist()))
        assert pairs == gpairs
        assert len(set(ub.ea_idx[keep].tolist())) == len(gpairs)
        assert ub.to("cpu")[6] is ub.to(torch.device("cpu"))[6]


# --------------------------------------------------------------------------
# the host check of the extend-add tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fault,match", [
    ("row", "row past its slab"),
    ("slab", "slab past the end"),
    ("length", "row table of"),
])
def test_check_windows_catches_bad_extend_add_tables(chol_plan, fault,
                                                     match):
    plan = chol_plan
    check_windows(plan)
    ub = max(_ubs(plan), key=lambda u: u.slab_rows)
    saved = ub.tgt_lrow, ub.slab_lo
    try:
        if fault == "row":
            ub.tgt_lrow = ub.tgt_lrow.copy()
            ub.tgt_lrow.flat[np.argmax(ub.tgt_lrow)] = ub.slab_rows
        elif fault == "slab":
            ub.slab_lo = np.asarray([plan.storage - ub.csp], np.int32)
        else:
            ub.tgt_lrow = ub.tgt_lrow[:, :-1]
        with pytest.raises(ValueError, match=match):
            check_windows(plan)
    finally:
        ub.tgt_lrow, ub.slab_lo = saved
    check_windows(plan)
