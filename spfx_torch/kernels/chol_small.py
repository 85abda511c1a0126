"""Batched Cholesky of small SPD matrices.

Port of ``cholesky_small_batched`` (spfx/kernels/pallas_blocks.py):
``cholesky_small_batched(D)`` takes D (batch, c, c), c <= 32, and returns
the lower Cholesky factors (batch, c, c) with exact zeros above the
diagonal; float32 and float64.

- Only D's lower triangle is read. The TPU kernel's result ignores finite
  values above the diagonal too, but NaN or Inf there reaches its L
  (column j comes out of a one-hot contraction over whole rows, and
  NaN * 0 is NaN); the port's does not.
- A non-positive pivot gives NaN, as the TPU kernel's rsqrt does; nothing
  is checked.
- The JAX kernel's ``slab`` (tasks a grid step keeps in VMEM) has no
  counterpart, and c is held to the documented range c <= 32, where the
  JAX kernel takes any c whose slab fits VMEM.

No engine of either package calls it. A CPU tensor takes the plain PyTorch
version (``cholesky_small_batched_plain``, the same column recurrence); a
CUDA tensor launches the kernel of csrc/chol_small.cu or raises.
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import _cuda

C_MAX = 32


def _check(D) -> None:
    if D.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cholesky_small_batched: D must be float32 or "
                        f"float64, got {D.dtype}")
    if D.dim() != 3 or D.shape[1] != D.shape[2] or D.shape[1] < 1:
        raise ValueError(f"cholesky_small_batched: D must be (batch, c, c), "
                         f"got {tuple(D.shape)}")
    if D.shape[1] > C_MAX:
        raise ValueError(f"cholesky_small_batched: c = {D.shape[1]} exceeds "
                         f"the limit c <= {C_MAX}")
    if not D.is_contiguous():
        raise ValueError("cholesky_small_batched: D must be contiguous")
    if D.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cholesky_small_batched: unsupported device "
                         f"{D.device}")


def cholesky_small_batched_plain(D):
    """Plain PyTorch version: the kernel's column recurrence over the
    batch (column j scaled by rsqrt(d_jj), then the trailing rank-1
    update)."""
    A = torch.tril(D)
    for j in range(D.shape[-1]):
        A[:, j:, j] *= torch.rsqrt(A[:, j, j])[:, None]
        A[:, j + 1:, j + 1:] -= A[:, j + 1:, j, None] * A[:, None, j + 1:, j]
    return torch.tril(A)


def cholesky_small_batched(D):
    """Lower Cholesky factors of the (batch, c, c) blocks (see module
    docstring)."""
    _check(D)
    if D.device.type == "cpu":
        return cholesky_small_batched_plain(D)
    batch, c = D.shape[0], D.shape[1]
    L = torch.empty_like(D)
    fn = getattr(_cuda.lib("chol_small"), "spfx_cholesky_small_batched_"
                 + ("f32" if D.dtype == torch.float32 else "f64"))
    rc = fn(D.data_ptr(), L.data_ptr(), batch, c, _cuda.stream_ptr(D.device))
    _cuda.check(rc, "cholesky_small_batched")
    if batch:
        _cuda.count("cholesky_small_batched")
    return L
