"""Batched factorizations + explicit inverses of (nb, nb) diagonal blocks,
nb <= 32: the serial part of the blocked panel paths.

Port of ``potrf_inv_lanes`` (spfx/kernels/pallas_blocks.py), task-major:
``potrf_inv(wrel, D)`` takes D (B, nb, nb) and the valid widths wrel (B,)
and returns (L, Linv), each (B, nb, nb):

- only D's lower triangle is read (its upper triangle holds trailing-update
  junk in the blocked panel path); rows and columns >= wrel are replaced by
  the identity;
- L = chol of that block, zeroed on the padding (wrel == 0 gives L = 0);
- Linv = its inverse, with unit rows on the padding (wrel == 0 gives I), so
  multiplying by Linv leaves padded columns alone.

Port of ``getrf_inv_lanes``, task-major: ``getrf_inv(wrel, D)`` takes the
same shapes and returns (L, U, Linv, Uinv), each (B, nb, nb):

- the whole live block is read (below the diagonal the L side, above it
  the U side); rows and columns >= wrel are replaced by the identity;
- L (unit lower) and U = the no-pivot LU of that block, both zeroed on the
  padding (wrel == 0 gives L = U = 0);
- Linv and Uinv = the inverses of the unmasked L and U, the identity on
  the padding (wrel == 0 gives I).

Complex blocks (complex64, complex128) take the same contracts: for
``potrf_inv`` the block is Hermitian, L L^H = D with real positive pivots
(the real part of each diagonal entry is taken, and L's diagonal is stored
real); ``getrf_inv`` divides in complex arithmetic. Neither conjugates
anything else.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
CUDA kernel (csrc/potrf_inv.cu, csrc/getrf_inv.cu; complex blocks
csrc/potrf_inv_c.cu and csrc/getrf_inv_c.cu, counted as ``potrf_inv_c``
/ ``getrf_inv_c``) or raises.
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import _cuda

NB = 32                    # diagonal block size of the blocked panel path

# dtype -> the suffix of the C entry points
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex64: "c64", torch.complex128: "c128"}


def _check(name: str, wrel, D) -> None:
    if D.dtype not in _SUFFIX:
        raise TypeError(f"{name}: D must be float32, float64, complex64 or "
                        f"complex128, got {D.dtype}")
    if D.dim() != 3 or D.shape[1] != D.shape[2] or not 1 <= D.shape[1] <= NB:
        raise ValueError(f"{name}: D must be (B, nb, nb) with nb <= {NB},"
                         f" got {tuple(D.shape)}")
    if not D.is_contiguous():
        raise ValueError(f"{name}: D must be contiguous")
    if wrel.dtype != torch.int32 or wrel.shape != (D.shape[0],) \
            or not wrel.is_contiguous():
        raise ValueError(f"{name}: wrel must be a contiguous (B,) int32 "
                         "tensor")
    if wrel.device != D.device:
        raise ValueError(f"{name}: wrel on {wrel.device}, D on {D.device}")
    if D.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {D.device}")


def _launch(name: str, wrel, D, outs) -> None:
    """Launch kernel ``name`` on CUDA tensors: inputs (wrel, D), outputs
    ``outs`` of D's shape; library and count ``name`` for real blocks,
    ``name``_c for complex ones."""
    B, nb = D.shape[0], D.shape[1]
    what = name + ("_c" if D.is_complex() else "")
    fn = getattr(_cuda.lib(what), f"spfx_{name}_{_SUFFIX[D.dtype]}")
    rc = fn(wrel.data_ptr(), D.data_ptr(), *(o.data_ptr() for o in outs),
            B, nb, _cuda.stream_ptr(D.device))
    _cuda.check(rc, what)
    if B:
        _cuda.count(what)


def masked_block(wrel, D):
    """D's lower triangle on the live rows/cols, identity on the padding."""
    nb = D.shape[-1]
    i = torch.arange(nb, device=D.device)
    cm = i[None, :] < wrel[:, None]                       # (B, nb)
    keep = cm[:, :, None] & cm[:, None, :] & (i[:, None] >= i[None, :])
    eye = (~cm)[:, :, None] & (i[:, None] == i[None, :])
    return torch.where(keep, D, 0) + eye.to(D.dtype), cm


def potrf_inv_plain(wrel, D):
    """Plain PyTorch version, the kernel's recurrence batched over B
    (complex: Hermitian, real pivots, the trailing update conjugated)."""
    nb = D.shape[-1]
    A, cm = masked_block(wrel, D)
    cplx = A.is_complex()
    for j in range(nb):
        piv = torch.rsqrt(A[:, j, j].real if cplx else A[:, j, j])
        A[:, j:, j] *= piv[:, None]
        if cplx:
            A[:, j, j] = A[:, j, j].real.clone()
        A[:, j + 1:, j + 1:] -= (A[:, j + 1:, j, None]
                                 * A[:, None, j + 1:, j].conj())
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
    _check("potrf_inv", wrel, D)
    if D.device.type == "cpu":
        return potrf_inv_plain(wrel, D)
    outs = (torch.empty_like(D), torch.empty_like(D))
    _launch("potrf_inv", wrel, D, outs)
    return outs


def masked_full_block(wrel, D):
    """D on the live rows/cols (both triangles), identity on the padding."""
    nb = D.shape[-1]
    cm = torch.arange(nb, device=D.device)[None, :] < wrel[:, None]
    live = cm[:, :, None] & cm[:, None, :]
    return torch.where(live, D, 0) + torch.diag_embed((~cm).to(D.dtype)), cm


def getrf_inv_plain(wrel, D):
    """Plain PyTorch version, the kernel's recurrence batched over B."""
    nb = D.shape[-1]
    A, cm = masked_full_block(wrel, D)
    # right-looking no-pivot LU: column k below the pivot becomes L's
    # column (divided by the pivot, as the TPU kernel does), the trailing
    # block takes the rank-1 update
    for k in range(nb - 1):
        lcol = A[:, k + 1:, k] / A[:, k, k, None]
        A[:, k + 1:, k + 1:] -= lcol[:, :, None] * A[:, None, k, k + 1:]
        A[:, k + 1:, k] = lcol
    eye = torch.eye(nb, dtype=D.dtype, device=D.device)
    Lu = torch.tril(A, -1) + eye                    # unit L, unmasked
    U = torch.triu(A)
    # Linv by row-serial forward substitution (unit diagonal); Uinv as the
    # transpose of the lower inverse of U^T, dividing by the pivots
    X = torch.zeros_like(A)
    Y = torch.zeros_like(A)
    Ut = U.transpose(1, 2)
    for i in range(nb):
        X[:, i, :] = eye[i] - torch.bmm(Lu[:, i:i + 1, :i], X[:, :i, :])[:, 0]
        acc = torch.bmm(Ut[:, i:i + 1, :i], Y[:, :i, :])[:, 0, :]
        Y[:, i, :] = (eye[i] - acc) / Ut[:, i, i, None]
    live = (cm[:, :, None] & cm[:, None, :]).to(D.dtype)
    return Lu * live, U * live, X, Y.transpose(1, 2).contiguous()


def getrf_inv(wrel, D):
    """(L, U, Linv, Uinv) of the masked (B, nb, nb) blocks (see module
    docstring)."""
    _check("getrf_inv", wrel, D)
    if D.device.type == "cpu":
        return getrf_inv_plain(wrel, D)
    outs = tuple(torch.empty_like(D) for _ in range(4))
    _launch("getrf_inv", wrel, D, outs)
    return outs
