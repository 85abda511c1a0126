"""Configs that the port factors but that no other port test holds,
against the JAX package on the CPU: each for Cholesky and LU at
laplacian_3d(6), f64 unless named, against JAX's per-call engine (its
fused one for the fused config): the flat factors within 1e-12 of the
largest entry (the UT-step tolerance), and the port's refined solve's
scaled residual within 1e-12."""

import numpy as np
import pytest

pytest.importorskip("jax")

import spfx

import spfx_torch
from spfx_torch import Config
from spfx_torch.io import generate
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

TOL = 1e-12
CONFIGS = {
    "rowwin-update_windowing": dict(layout="rowwin", update_windowing=True),
    "rowwin-stride_padding": dict(layout="rowwin", stride_padding=True),
    "rowwin-max_pad_ratio_2": dict(layout="rowwin", max_pad_ratio=2.0),
    "max_pad_ratio_4": dict(max_pad_ratio=4.0),
    "pow2_classes": dict(class_granularity="pow2"),
    "max_sn_cols_16": dict(max_sn_cols=16),
    "max_gather_elems_4096": dict(max_gather_elems=4096),
    "max_region_elems_4096": dict(max_region_elems=4096),
    "camd": dict(ordering="camd"),
    "identity": dict(ordering="identity"),
    "fused-3_calls": dict(layout="rowwin", engine="fused",
                          calls_per_chunk=3),
    "complex128-rowwin-stride_padding": dict(dtype="complex128",
                                             layout="rowwin",
                                             stride_padding=True),
}


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=TOL * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("lu", [False, True], ids=["chol", "lu"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_config_matches_jax(config, lu):
    kw = dict(CONFIGS[config])
    dtype = kw.pop("dtype", "float64")
    A = generate.laplacian_3d(6)
    if dtype.startswith("complex"):
        # the pattern of the Laplacian with Hermitian (Cholesky) or
        # unsymmetric (LU) complex values
        from spfx_torch.bench.kernel_probe import magnetic_laplacian
        A = magnetic_laplacian(6, unsym=lu)
    jk = spfx.LU if lu else spfx.Cholesky
    tk = spfx_torch.LU if lu else spfx_torch.Cholesky
    jf = jk(A, spfx.Config(dtype=dtype, **{"engine": "calls", **kw})
            ).factorize(A)
    f = tk(A, Config(dtype=dtype, **kw), device="cpu").factorize(A)
    for k in ("Lx", "Ux") if lu else ("L",):
        _close(getattr(f, k).numpy(), getattr(jf, k), k)
    b = spfx_torch.synth_rhs(A)
    assert spfx_torch.scaled_residual(A, f.solve(b), b) <= 1e-12
