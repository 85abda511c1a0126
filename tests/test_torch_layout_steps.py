"""Every step of the UC and rowwin plans against the JAX package's
per-call primitive on the same state: UC update steps
(``apply_updates_sym_c`` / ``apply_updates_lu_c``), rowwin U steps
(``apply_updates_sym`` / ``apply_updates_lu``), rowwin P steps
(``factor_panels_chol`` / ``factor_panels_lu``) and the PC steps of a UC
plan, for Cholesky and LU, f32 and f64, within 1e-12 (f64) and 1e-5 (f32)
of each array's largest entry."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp

from spfx.kernels import blocks as jblocks
from spfx.plan.schedule import PanelBucketC as JPanelBucketC
from spfx.plan.schedule import UpdateBucket as JUpdateBucket
from spfx.plan.schedule import UpdateBucketC as JUpdateBucketC

from spfx_torch.kernels import blocks, mega
from test_torch_layouts import CASE_IDS, CASES, DTYPES, LAYOUTS, _close, \
    _contexts
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()


def _jax_step(arrays, b, lu):
    """JAX's per-call primitive for bucket ``b`` (the calls engine's
    dispatch); returns the new arrays as a tuple."""
    if isinstance(b, JUpdateBucketC):
        assert b.head_start is None
        fn = jblocks.apply_updates_lu_c if lu else jblocks.apply_updates_sym_c
        out = fn(*arrays, *b.dev(), mp=b.mp, kp=b.kp, csp=b.csp,
                 srows=b.slab_rows)
    elif isinstance(b, JUpdateBucket):
        fn = jblocks.apply_updates_lu if lu else jblocks.apply_updates_sym
        out = fn(*arrays, *b.dev(), kp=b.kp, csp=b.csp)
    elif isinstance(b, JPanelBucketC):
        fn = jblocks.factor_panels_lu_uj if lu \
            else jblocks.factor_panels_chol_uj
        out = fn(*arrays, *b.dev_u(), cp=b.cp, rbp=b.rbp)
    else:
        fn = jblocks.factor_panels_lu if lu else jblocks.factor_panels_chol
        out = fn(*arrays, *b.dev()[:3])
    return out if lu else (out,)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,lu", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_step_matches_jax(layout, name, lu, dtype):
    """The plan walked from A's entry values, update steps then panel
    steps per level: before each step the port's arrays are set to JAX's,
    then both take the step (the port in place through
    ``mega.update_step`` / ``mega.panel_step``, JAX through its per-call
    primitive) and agree within TOL of each array's largest entry."""
    A, jctx, tctx = _contexts(name, lu, dtype, **LAYOUTS[layout])
    vals = tctx.entry_values(A)
    vals = vals if lu else (vals,)
    idx = (tctx.plan.assembly_idx, tctx.plan.assembly_idx_u)
    state = [np.asarray(blocks.assemble(torch.from_numpy(i), v,
                                        tctx.plan.storage))
             for i, v in zip(idx, vals)]
    jsteps = [(b, k) for lp in jctx.plan.levels
              for b, k in [(u, "U") for u in lp.updates]
              + [(p, "P") for p in lp.panels]]
    tsteps = [b for lp in tctx.plan.levels
              for b in list(lp.updates) + list(lp.panels)]
    assert len(jsteps) == len(tsteps)
    for i, ((jb, kind), tb) in enumerate(zip(jsteps, tsteps)):
        ref = [np.asarray(a) for a in
               _jax_step([jnp.asarray(s.copy()) for s in state], jb, lu)]
        arrays = [torch.from_numpy(s.copy()) for s in state]
        ptrs = [a.data_ptr() for a in arrays]
        if kind == "U":
            mega.update_step(arrays, tb, "cpu", lu)
        else:
            mega.panel_step(arrays, tb, "cpu", lu, "blocked")
        assert [a.data_ptr() for a in arrays] == ptrs
        for got, want in zip(arrays, ref):
            _close(got.numpy(), want, dtype, f"step {i} ({kind})")
        state = ref
    assert np.isfinite(state[0]).all()
