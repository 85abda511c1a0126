"""The port's subtree-decomposed engines (spfx_torch.dist.subtree:
SubtreeCholesky, SubtreeLU, sn_parent, assign_owners) against the JAX
package's (spfx.dist.subtree), on the CPU.

The port's ranks run in gloo groups of 2 and 4 processes
(``test_torch_ranks.spawn``, one spawn per world size); world 1 runs in
the test process. The JAX side runs here on a mesh of the same size. The
matrices and config are tests/test_subtree.py's: ``Config(dtype=
"float64", ordering="nd", solve_backend="device")`` at laplacian_3d(6),
(7) and (8), laplacian_2d(64) and random_unsym(80, 0.05, seed=5).

Owners and parents equal JAX's bit for bit; every plan (each rank's
filtered plan, the top plan, the full plan) equals JAX's table by table;
the dense-reconstructed factor within 1e-11 of JAX's; the refined
residuals below 1e-12."""

import functools
import importlib.util

import numpy as np
import pytest

from spfx_torch import Config
from spfx_torch.dist import (SubtreeCholesky, SubtreeLU, assign_owners,
                             make_mesh, sn_parent)
from spfx_torch.dist import mesh as dmesh
from spfx_torch.interop import plan_arrays
from spfx_torch.io import generate
from spfx_torch.plan.schedule import build_plan
from spfx_torch.symbolic.analyze import analyze
from spfx_torch.validate import scaled_residual, synth_rhs
from test_torch_ranks import join, load, save, spawn

pytestmark = pytest.mark.skipif(importlib.util.find_spec("jax") is None,
                                reason="the JAX reference needs jax")

CFG = dict(dtype="float64", ordering="nd", solve_backend="device")
MATRICES = {
    "lap6": lambda: generate.laplacian_3d(6),
    "lap7": lambda: generate.laplacian_3d(7),
    "lap8": lambda: generate.laplacian_3d(8),
    "lap2d64": lambda: generate.laplacian_2d(64),
    "unsym80": lambda: generate.random_unsym(80, density=0.05, seed=5),
}
# name: (LU?, matrix)
CASES = {"chol": (False, "lap6"), "chol_lap7": (False, "lap7"),
         "lu_unsym80": (True, "unsym80"), "lu_lap6": (True, "lap6")}
WORLDS = {1: ("chol", "chol_lap7"), 2: tuple(CASES), 4: ("chol",)}


def port_case(case, mesh):
    """One case on this rank: the dense factor, the refined residual, the
    flop and level counts, the collectives and the plans' tables."""
    lu, mat = CASES[case]
    A = MATRICES[mat]()
    dmesh.reset_collective_counts()
    st = (SubtreeLU if lu else SubtreeCholesky)(A, Config(**CFG), mesh=mesh)
    f = st.factorize(A)
    counts = dmesh.collective_counts()
    b = synth_rhs(A)
    out = dict(residual=scaled_residual(A, f.solve(b), b),
               local_flops=np.asarray(st.local_flops),
               top_flops=st.top_flops, top_levels=st.top_levels,
               all_reduce=counts["all_reduce"],
               want_all_reduce=(1 + sum(bool(lp.updates) + bool(lp.panels)
                                        for lp in st.top_plan.levels))
               * (2 if lu else 1))
    if lu:
        Lh, Uh = f.LU_sparse()
        out.update(L=Lh.toarray(), U=Uh.toarray())
    else:
        out["L"] = f.L_sparse().toarray()
    for tag, plan in (("local", st.local_plan), ("top", st.top_plan),
                      ("full", st.plan)):
        out.update({f"{tag}/{k}": v for k, v in plan_arrays(plan).items()})
    return out


def rank_main(world, rank, tmp):
    mesh = join(world, rank, tmp)
    for case in WORLDS[world]:
        save(tmp, case, rank, **port_case(case, mesh))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {1: None}
    for world in (2, 4):
        out[world] = spawn("test_torch_subtree", world,
                           tmp_path_factory.mktemp(f"subtree{world}"))
    return out


@functools.lru_cache(maxsize=None)
def world_one(case):
    return port_case(case, make_mesh("d", devices=["cpu"]))


def port_result(ranks, world, case, rank=0):
    if world == 1:
        return world_one(case)
    return load(ranks[world], case, rank)


def _jax():
    from test_torch_reference import ensure_reference_planner
    ensure_reference_planner()


@functools.lru_cache(maxsize=None)
def jax_subtree(case, ndev):
    """JAX's subtree engine on a mesh of ``ndev``: its dense factor, flops,
    top levels and full plan's slack."""
    import jax
    from spfx.dist.mesh import make_mesh as jmesh
    from spfx.dist.subtree import SubtreeCholesky as JC, SubtreeLU as JL
    from spfx.utils.config import Config as JConfig
    _jax()
    lu, mat = CASES[case]
    A = MATRICES[mat]()
    st = (JL if lu else JC)(A, JConfig(**CFG),
                            mesh=jmesh("d", jax.devices()[:ndev]))
    f = st.factorize(A)
    out = dict(local_flops=np.asarray(st.local_flops),
               top_flops=st.top_flops, top_levels=st.top_levels,
               slack=st.plan.slack)
    if lu:
        Lh, Uh = f.LU_sparse()
        out.update(L=Lh.toarray(), U=Uh.toarray())
    else:
        out["L"] = f.L_sparse().toarray()
    return out


# ---------------------------------------------------------------------------
# host: the supernodal tree, the owners and the plans
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def symbolics(mat):
    from spfx.symbolic.analyze import analyze as janalyze
    from spfx.utils.config import Config as JConfig
    _jax()
    A = MATRICES[mat]()
    return A, analyze(A, Config(**CFG)), janalyze(A, JConfig(**CFG))


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("mat", ["lap8", "lap2d64"])
def test_owners_match_jax(mat, ndev):
    from spfx.dist.subtree import assign_owners as jowners, \
        sn_parent as jparent
    _, sym, jsym = symbolics(mat)
    np.testing.assert_array_equal(sym.perm, jsym.perm)
    par, jpar = sn_parent(sym), jparent(jsym)
    assert par.dtype == jpar.dtype and np.array_equal(par, jpar)
    own, jown = assign_owners(sym, ndev), jowners(jsym, ndev)
    assert own.dtype == jown.dtype and np.array_equal(own, jown)
    assert set(range(ndev)) <= set(own[own >= 0].tolist())


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
@pytest.mark.parametrize("which", ["rank0", "rank1", "top", "full"])
def test_plans_match_jax(which, lu):
    """Each filtered plan at ndev 2, the top plan and the full plan, built
    with the owners' storage key, equal JAX's table by table."""
    from spfx.plan.schedule import build_plan as jbuild
    from spfx.utils.config import Config as JConfig
    A, sym, jsym = symbolics("lap6")
    owner = assign_owners(sym, 2)
    filt = {"rank0": owner == 0, "rank1": owner == 1, "top": owner == -1,
            "full": None}[which]
    kw = dict(lu=lu, sn_filter=filt, sn_group=owner + 1)
    ja = plan_arrays(jbuild(jsym, A, JConfig(**CFG), **kw))
    ta = plan_arrays(build_plan(sym, A, Config(**CFG), **kw))
    assert sorted(ja) == sorted(ta)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


def test_rank_plans_share_one_layout(ranks):
    """At world 2 each rank's plans take one slack, JAX's; the full plan is
    the same on both ranks, and the filtered plans' layout is its."""
    want = jax_subtree("chol", 2)["slack"]
    r0, r1 = (load(ranks[2], "chol", r) for r in range(2))
    for r in (r0, r1):
        for tag in ("local", "top", "full"):
            assert int(r[f"{tag}/slack"]) == want
            for k in ("offsets", "strides", "assembly_idx"):
                assert np.array_equal(r[f"{tag}/{k}"], r0[f"full/{k}"])
    full = [k for k in r0 if k.startswith("full/")]
    assert all(np.array_equal(r0[k], r1[k]) for k in full)
    assert int(r0["local/nlevels"]) and int(r1["local/nlevels"])


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 4])
def test_subtree_cholesky_matches_jax(ranks, world):
    got = port_result(ranks, world, "chol")
    want = jax_subtree("chol", world)
    np.testing.assert_allclose(got["L"], want["L"], rtol=1e-11, atol=1e-11)
    np.testing.assert_array_equal(got["local_flops"], want["local_flops"])
    assert float(got["top_flops"]) == want["top_flops"]
    assert int(got["top_levels"]) == want["top_levels"]
    assert got["residual"] < 1e-12


@pytest.mark.parametrize("world", [1, 2])
def test_subtree_cholesky_residual(ranks, world):
    got = port_result(ranks, world, "chol_lap7")
    assert got["residual"] < 1e-12
    assert got["local_flops"].sum() > 0.2 * float(got["top_flops"])


@pytest.mark.parametrize("case", ["lu_unsym80", "lu_lap6"])
def test_subtree_lu_residual(ranks, case):
    got = load(ranks[2], case)
    assert got["residual"] < 1e-12


def test_subtree_lu_matches_jax(ranks):
    got = load(ranks[2], "lu_unsym80")
    want = jax_subtree("lu_unsym80", 2)
    for n in ("L", "U"):
        np.testing.assert_allclose(got[n], want[n], rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_hold_one_factor(ranks, world):
    """Every rank ends with the same factor, having made one merge
    all-reduce and one a top level phase (per factor array), and loaded no
    jax."""
    for case in WORLDS[world]:
        r0 = load(ranks[world], case)
        for r in range(world):
            rr = load(ranks[world], case, r)
            for n in ("L", "U"):
                if n in rr:
                    assert np.array_equal(rr[n], r0[n]), (case, r, n)
            assert int(rr["all_reduce"]) == int(rr["want_all_reduce"])
            assert not rr["jax_loaded"]


def test_rowwin_refused():
    """layout="rowwin" raises, as JAX's does."""
    import jax
    from spfx.dist.mesh import make_mesh as jmesh
    from spfx.dist.subtree import SubtreeCholesky as JC
    from spfx.utils.config import Config as JConfig
    A = generate.laplacian_3d(4)
    with pytest.raises(ValueError, match="layout='contig'"):
        JC(A, JConfig(**CFG, layout="rowwin"),
           mesh=jmesh("d", jax.devices()[:1]))
    with pytest.raises(ValueError, match="layout='contig'"):
        SubtreeCholesky(A, Config(**CFG, layout="rowwin"),
                        mesh=make_mesh(devices=["cpu"]))
