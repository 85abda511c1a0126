"""UT gather windows that are not a multiple of ALIGN = 1024 elements,
against the JAX package on the CPU.

An update step's source superwindow is (mp + ALIGN / kp) kp elements: a
multiple of ALIGN only where mp kp is one. Two configs of the JAX
package's own tests build plans whose windows are not
(``test_tiled_tall_task_tiles``: update_tile=16, update_small=8, windows
of 1,280 and 1,536; ``test_class_min_coarse_classes``: class_min=8,
stride_min=0, 1,280). Both factor here, Cholesky and LU, f64 and f32, and
the plain window gather takes any positive window as the XLA gather does.
Tolerances are those of the UT-step tests: 1e-12 (f64) and 1e-5 (f32) of
the array's largest entry."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp

import spfx
from spfx.kernels import blocks as jblocks

import spfx_torch
from spfx_torch import Config
from spfx_torch.io import generate
from spfx_torch.kernels import gather
from spfx_torch.plan.schedule import ALIGN
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

TOL = {"float32": 1e-5, "float64": 1e-12}
# the two configs, and the windows their 6^3 plans hold that are not a
# multiple of ALIGN
FAULT_CONFIGS = {"tall_tiles": (dict(update_tile=16, update_small=8),
                                {1280, 1536}),
                 "fine_classes": (dict(ordering="nd", class_min=8,
                                       stride_min=0), {1280})}


def odd_windows(plan) -> set:
    """The UT source superwindows of ``plan`` that are not a multiple of
    ALIGN."""
    return {(ub.mp + ALIGN // ub.kp) * ub.kp
            for lp in plan.levels for ub in lp.updates
            if getattr(ub, "head_start", None) is not None
            and (ub.mp + ALIGN // ub.kp) * ub.kp % ALIGN}


def _close(got, ref, dtype, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=TOL[dtype] * np.abs(ref).max(),
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
@pytest.mark.parametrize("config", list(FAULT_CONFIGS))
def test_odd_window_configs_match_jax(config, lu, dtype):
    """Flat factors and solutions of laplacian_3d(6) under the config
    against JAX's (per-call engine), and the plan really holds the windows
    that are not a multiple of ALIGN."""
    kw, windows = FAULT_CONFIGS[config]
    A = generate.laplacian_3d(6)
    jk = spfx.LU if lu else spfx.Cholesky
    tk = spfx_torch.LU if lu else spfx_torch.Cholesky
    jf = jk(A, spfx.Config(dtype=dtype, engine="calls", **kw)).factorize(A)
    ctx = tk(A, Config(dtype=dtype, **kw), device="cpu")
    assert odd_windows(ctx.plan) == windows
    f = ctx.factorize(A)
    for k in ("Lx", "Ux") if lu else ("L",):
        _close(getattr(f, k).numpy(), getattr(jf, k), dtype, k)
    b = spfx_torch.synth_rhs(A)
    x = f.solve(b)
    _close(x, jf.solve(b), dtype, "x")
    assert spfx_torch.scaled_residual(A, x, b) <= 1e-12


@pytest.mark.parametrize("win", [1280, 1027, 1])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_window_gather_any_window_matches_xla(win, dtype):
    """window_gather2 (the plain version on the CPU) at a window that is
    not a multiple of ALIGN, with dead windows, against JAX's windowed XLA
    gather, bit for bit; _check accepts the window."""
    rng = np.random.default_rng(win)
    flat = rng.standard_normal(6 * ALIGN).astype(dtype)
    starts = np.array([0, 1500, -1, 4 * ALIGN + 3, -9], dtype=np.int32)
    L = torch.from_numpy(flat)
    s = torch.from_numpy(starts)
    gather._check(L, s, win, "test")
    ref = np.asarray(jblocks._task_gather_aligned(
        jnp.asarray(flat), jnp.asarray(starts), win, 1)).reshape(-1, win)
    a, b = gather.window_gather2(L, s, win, s[:2].contiguous(), ALIGN)
    np.testing.assert_array_equal(a.numpy(), ref)
    np.testing.assert_array_equal(b.numpy(), flat[:2 * ALIGN].reshape(2, -1))
    np.testing.assert_array_equal(
        gather.window_gather_plain(L, s, win).numpy(), ref)
    assert (a[2] == 0).all() and (a[4] == 0).all()
