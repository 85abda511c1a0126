"""Factor checkpoints across the two packages: a factor saved by the JAX
package loads in the port and the reverse, with the same .npz keys, and
each loaded factor solves as the saved one did (after
tests/test_checkpoint.py)."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import spfx
from spfx import checkpoint as jcheckpoint

import spfx_torch
from spfx_torch import checkpoint
from spfx_torch.io import generate
from test_torch_reference import ensure_reference_planner, one_torch_thread

ensure_reference_planner()
one_torch_thread()

F64 = dict(dtype="float64", ordering="nd")
# refine=0 solves of one factor's values: Cholesky 1e-13, LU 1e-12 (as in
# tests/test_checkpoint.py)
KINDS = {
    "chol": (lambda: generate.laplacian_2d(12), spfx.cholesky,
             spfx_torch.cholesky, 1e-13),
    "lu": (lambda: generate.random_unsym(40, density=0.1, seed=33), spfx.lu,
           spfx_torch.lu, 1e-12),
}


def _arrays(f):
    ts = (f.Lx, f.Ux) if hasattr(f, "Ux") else (f.L,)
    return [t.numpy() if torch.is_tensor(t) else np.asarray(t) for t in ts]


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax",
                                       "torch-to-torch"])
def test_roundtrip(tmp_path, kind, direction):
    make, jfactor, tfactor, tol = KINDS[kind]
    A = make()
    src, dst = direction.split("-to-")
    if src == "jax":
        f = jfactor(A, spfx.Config(**F64))
        save = jcheckpoint.save_factor
    else:
        f = tfactor(A, spfx_torch.Config(**F64), device="cpu")
        save = checkpoint.save_factor
    p = tmp_path / f"{kind}.npz"
    save(p, f)
    if dst == "jax":
        g = jcheckpoint.load_factor(p, config=spfx.Config(**F64))
    else:
        g = checkpoint.load_factor(p, config=spfx_torch.Config(**F64),
                                   device="cpu")
        assert all(t.device.type == "cpu" for t in
                   ((g.Lx, g.Ux) if kind == "lu" else (g.L,)))
    for a, b in zip(_arrays(f), _arrays(g)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    b = spfx_torch.synth_rhs(A)
    x1 = f.solve(b, refine=0)
    x2 = g.solve(b, refine=0)
    assert np.abs(x1 - x2).max() < tol
    assert spfx_torch.scaled_residual(A, g.solve(b), b) < 1e-12


def test_layout_mismatch_raises(tmp_path):
    """A config whose plan lays the factor out otherwise is refused."""
    A = generate.laplacian_2d(12)
    f = spfx_torch.cholesky(A, spfx_torch.Config(**F64), device="cpu")
    p = tmp_path / "chol.npz"
    checkpoint.save_factor(p, f)
    with pytest.raises(ValueError, match="layout"):
        checkpoint.load_factor(p, config=spfx_torch.Config(**F64,
                                                           pad_min=64),
                               device="cpu")
