"""Batched Cholesky + explicit inverse of (nb, nb) diagonal blocks, nb <= 32.

Port of ``potrf_inv_lanes`` (spfx/kernels/pallas_blocks.py), task-major:
``potrf_inv(wrel, D)`` takes D (B, nb, nb) and the valid widths wrel (B,)
and returns (L, Linv), each (B, nb, nb):

- only D's lower triangle is read (its upper triangle holds trailing-update
  junk in the blocked panel path); rows and columns >= wrel are replaced by
  the identity;
- L = chol of that block, zeroed on the padding (wrel == 0 gives L = 0);
- Linv = its inverse, with unit rows on the padding (wrel == 0 gives I), so
  multiplying by Linv leaves padded columns alone.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
CUDA kernel (csrc/potrf_inv.cu) or raises.
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import _cuda

NB = 32                    # diagonal block size of the blocked panel path


def _check(wrel, D) -> None:
    if D.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"potrf_inv: D must be float32 or float64, got "
                        f"{D.dtype}")
    if D.dim() != 3 or D.shape[1] != D.shape[2] or not 1 <= D.shape[1] <= NB:
        raise ValueError(f"potrf_inv: D must be (B, nb, nb) with nb <= {NB},"
                         f" got {tuple(D.shape)}")
    if not D.is_contiguous():
        raise ValueError("potrf_inv: D must be contiguous")
    if wrel.dtype != torch.int32 or wrel.shape != (D.shape[0],) \
            or not wrel.is_contiguous():
        raise ValueError("potrf_inv: wrel must be a contiguous (B,) int32 "
                         "tensor")
    if wrel.device != D.device:
        raise ValueError(f"potrf_inv: wrel on {wrel.device}, D on "
                         f"{D.device}")


def masked_block(wrel, D):
    """D's lower triangle on the live rows/cols, identity on the padding."""
    nb = D.shape[-1]
    i = torch.arange(nb, device=D.device)
    cm = i[None, :] < wrel[:, None]                       # (B, nb)
    keep = cm[:, :, None] & cm[:, None, :] & (i[:, None] >= i[None, :])
    eye = (~cm)[:, :, None] & (i[:, None] == i[None, :])
    return torch.where(keep, D, 0) + eye.to(D.dtype), cm


def potrf_inv_plain(wrel, D):
    """Plain PyTorch version, the kernel's recurrence batched over B."""
    nb = D.shape[-1]
    A, cm = masked_block(wrel, D)
    for j in range(nb):
        piv = torch.rsqrt(A[:, j, j])
        A[:, j:, j] *= piv[:, None]
        A[:, j + 1:, j + 1:] -= A[:, j + 1:, j, None] * A[:, None, j + 1:, j]
    A = torch.tril(A)
    X = torch.zeros_like(A)
    eye = torch.eye(nb, dtype=D.dtype, device=D.device)
    for i in range(nb):
        acc = torch.bmm(A[:, i:i + 1, :i], X[:, :i, :])[:, 0, :]
        X[:, i, :] = (eye[i] - acc) / A[:, i, i, None]
    live = (cm[:, :, None] & cm[:, None, :]).to(D.dtype)
    return A * live, X


def potrf_inv(wrel, D):
    """(L, Linv) of the masked (B, nb, nb) blocks (see module docstring)."""
    _check(wrel, D)
    if D.device.type == "cpu":
        return potrf_inv_plain(wrel, D)
    if not D.is_cuda:
        raise ValueError(f"potrf_inv: unsupported device {D.device}")
    B, nb = D.shape[0], D.shape[1]
    L = torch.empty_like(D)
    Linv = torch.empty_like(D)
    lib = _cuda.lib("potrf_inv")
    fn = lib.spfx_potrf_inv_f32 if D.dtype == torch.float32 \
        else lib.spfx_potrf_inv_f64
    rc = fn(wrel.data_ptr(), D.data_ptr(), L.data_ptr(), Linv.data_ptr(),
            B, nb, _cuda.stream_ptr(D.device))
    _cuda.check(rc, "potrf_inv")
    if B:
        _cuda.count("potrf_inv")
    return L, Linv
