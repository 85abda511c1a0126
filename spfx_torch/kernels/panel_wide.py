"""Whole-panel Cholesky and no-pivot LU deltas of one PC bucket, task-major.

Port of ``chol_panel_deltas_wide`` and ``lu_panel_deltas_wide``
(spfx/kernels/pallas_blocks.py), with their signatures and layout:

- ``chol_panel_deltas_wide(widths, nbelow, Draw, Braw, cp, rbp)``: Draw
  (B, cp, cp) diagonal windows, Braw (B, rbp, cp) below blocks, widths and
  nbelow (B,) int32; returns ``(dd, db)`` in the same layouts. L11 is the
  Cholesky of the live w x w block read from Draw's lower triangle (the
  upper triangle is never read), L21 = B L11^{-T} on the live columns, and
  dd = L11 - Draw, db = L21 - Braw on the live block and the live rows
  (r < nbelow), 0 elsewhere.
- ``lu_panel_deltas_wide(widths, nbelow, DL, DU, BL, BU, cp, rbp)``: the
  front is DL on and below the diagonal and DU^T above it; its no-pivot LU
  L11 (unit) U11, then L21 = BL U11^{-1} and U12^T = BU L11^{-T} (unit);
  returns ``(ddl, ddu, dbl, dbu)``: L11 - DL, U11^T - DU, L21 - BL,
  U12^T - BU, masked in the same way.

cp <= 256; f32 or f64. ``rbp == 0`` returns a (B, 0, cp) below delta. A
CPU tensor takes the plain PyTorch version (``chol_panel_deltas_plain``,
``lu_panel_deltas_plain``, which the lanes family shares through a
transpose); a CUDA tensor launches the kernel of csrc/panel_wide.cu or
raises. The kernel is the lanes kernels' design in this layout (the
device code of csrc/panel_blocks.cuh): 32-column blocks over explicit
inverses of the 32 x 32 diagonal blocks, run as two launches (a diagonal
phase, one thread block per task, then a phase that solves the below
blocks 32 rows to a thread block, reading the factor from a workspace);
the pair counts as one launch.
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import _cuda
from spfx_torch.kernels.route import LANES_CP_MAX, WIDE_CP_MAX


def check_panel(name: str, widths, nbelow, diag, below, cp: int, rbp: int,
                lanes: bool) -> None:
    """Raise on anything a whole-panel kernel does not take: the diagonal
    windows ``diag`` (cp, cp, B) in lanes layout or (B, cp, cp) task-major,
    the below blocks ``below`` (rbp, cp, B) or (B, rbp, cp), all of one
    float dtype, contiguous, on one device with the (B,) int32 widths and
    nbelow."""
    cmax = LANES_CP_MAX if lanes else WIDE_CP_MAX
    if not 1 <= cp <= cmax:
        raise ValueError(f"{name}: cp must be in [1, {cmax}], got {cp}")
    if rbp < 0:
        raise ValueError(f"{name}: rbp must be >= 0, got {rbp}")
    dt = diag[0].dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: blocks must be float32 or float64, got "
                        f"{dt}")
    if widths.dim() != 1:
        raise ValueError(f"{name}: widths must be (B,), got "
                         f"{tuple(widths.shape)}")
    B = widths.shape[0]
    dev = diag[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    for what, t in (("widths", widths), ("nbelow", nbelow)):
        if t.dtype != torch.int32 or t.shape != (B,) or \
                not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous (B,) "
                             "int32 tensor")
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, blocks on "
                             f"{dev}")
    for shape, ts in (((cp, cp, B) if lanes else (B, cp, cp), diag),
                      ((rbp, cp, B) if lanes else (B, rbp, cp), below)):
        for t in ts:
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: expected a block of shape "
                                 f"{shape}, got {tuple(t.shape)}")
            if t.dtype != dt or t.device != dev:
                raise ValueError(f"{name}: blocks must share dtype and "
                                 "device")
            if not t.is_contiguous():
                raise ValueError(f"{name}: blocks must be contiguous")


def launch(lib_name: str, kind: str, widths, nbelow, ins, outs, cp: int,
           rbp: int) -> None:
    """Launch the ``kind`` ('chol' or 'lu') kernel of library ``lib_name``
    ('panel_lanes' or 'panel_wide') on CUDA tensors, with the workspace
    that its below-panel phase reads: the factor in rows 0 .. cp - 1 (for
    LU the combined one, L below the diagonal, U on and above it), then
    the inverses of its 32 x 32 diagonal blocks in 32 rows (Cholesky's L)
    or 64 (LU's L, then U); each row padded to a multiple of 32 values."""
    B = widths.shape[0]
    ws = ins[0].new_empty((B, cp + (64 if kind == "lu" else 32),
                           -(-cp // 32) * 32))
    fn = getattr(_cuda.lib(lib_name), f"spfx_{kind}_{lib_name}_"
                 + ("f32" if ins[0].dtype == torch.float32 else "f64"))
    rc = fn(widths.data_ptr(), nbelow.data_ptr(),
            *(t.data_ptr() for t in (*ins, *outs, ws)), B, cp, rbp,
            _cuda.stream_ptr(ins[0].device))
    _cuda.check(rc, f"{kind}_{lib_name}")
    if B:
        _cuda.count(f"{kind}_{lib_name}")


# --------------------------------------------------------------------------
# plain versions (task-major), shared with the lanes family
# --------------------------------------------------------------------------

def _masks(widths, nbelow, cp: int, rbp: int):
    """(cm (B, cp) live columns, live (B, cp, cp) block, bm (B, rbp, cp)
    live below entries), all bool."""
    cm = torch.arange(cp, device=widths.device)[None, :] < widths[:, None]
    rm = torch.arange(rbp, device=widths.device)[None, :] < nbelow[:, None]
    return (cm, cm[:, :, None] & cm[:, None, :],
            rm[:, :, None] & cm[:, None, :])


def _solve_upper_right(Bm, M, unit: bool):
    """X with X M = Bm: Bm (B, rows, cp), M (B, cp, cp) upper triangular;
    the column recurrence of _trsm_lanes."""
    X = Bm.clone()
    for j in range(M.shape[-1]):
        if not unit:
            X[:, :, j] /= M[:, j, j, None]
        X[:, :, j + 1:] -= X[:, :, j, None] * M[:, None, j, j + 1:]
    return X


def chol_panel_deltas_plain(widths, nbelow, Draw, Braw, cp: int, rbp: int):
    """Plain PyTorch version (task-major): the unblocked column recurrences
    of _potrf_lanes and _trsm_lanes, batched over B, on the live block
    padded with the identity."""
    cm, live, bm = _masks(widths, nbelow, cp, rbp)
    i = torch.arange(cp, device=Draw.device)
    lower = i[:, None] >= i[None, :]
    A = torch.where(live & lower, Draw, 0) \
        + torch.diag_embed((~cm).to(Draw.dtype))
    for j in range(cp):
        A[:, j:, j] *= torch.rsqrt(A[:, j, j])[:, None]
        A[:, j + 1:, j + 1:] -= A[:, j + 1:, j, None] * A[:, None, j + 1:, j]
    L = torch.tril(A)
    dd = torch.where(live, L - Draw, 0)
    if not rbp:
        return dd, Draw.new_zeros((Draw.shape[0], 0, cp))
    X = _solve_upper_right(torch.where(cm[:, None, :], Braw, 0),
                           L.transpose(1, 2), unit=False)
    return dd, torch.where(bm, X - Braw, 0)


def lu_panel_deltas_plain(widths, nbelow, DL, DU, BL, BU, cp: int, rbp: int):
    """Plain PyTorch version (task-major): the right-looking no-pivot
    elimination of _getrf_lanes and the column recurrences of _trsm_lanes,
    batched over B. Returns (ddl, ddu, dbl, dbu)."""
    cm, live, bm = _masks(widths, nbelow, cp, rbp)
    i = torch.arange(cp, device=DL.device)
    lower = i[:, None] >= i[None, :]
    A = torch.where(live & lower, DL, 0) \
        + torch.where(live & ~lower, DU.transpose(1, 2), 0) \
        + torch.diag_embed((~cm).to(DL.dtype))
    for k in range(cp - 1):
        lcol = A[:, k + 1:, k] / A[:, k, k, None]
        A[:, k + 1:, k + 1:] -= lcol[:, :, None] * A[:, None, k, k + 1:]
        A[:, k + 1:, k] = lcol
    L = torch.tril(A, -1) + torch.eye(cp, dtype=DL.dtype, device=DL.device)
    U = torch.triu(A)
    ddl = torch.where(live, L - DL, 0)
    ddu = torch.where(live, U.transpose(1, 2) - DU, 0)
    if not rbp:
        z = DL.new_zeros((DL.shape[0], 0, cp))
        return ddl, ddu, z, z
    XL = _solve_upper_right(torch.where(cm[:, None, :], BL, 0), U,
                            unit=False)
    XU = _solve_upper_right(torch.where(cm[:, None, :], BU, 0),
                            L.transpose(1, 2), unit=True)
    return (ddl, ddu, torch.where(bm, XL - BL, 0),
            torch.where(bm, XU - BU, 0))


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def chol_panel_deltas_wide(widths, nbelow, Draw, Braw, cp: int, rbp: int):
    """(dd, db) of task-major blocks (see module docstring)."""
    check_panel("chol_panel_deltas_wide", widths, nbelow, (Draw,), (Braw,),
                cp, rbp, lanes=False)
    if Draw.device.type == "cpu":
        return chol_panel_deltas_plain(widths, nbelow, Draw, Braw, cp, rbp)
    outs = (torch.empty_like(Draw), torch.empty_like(Braw))
    launch("panel_wide", "chol", widths, nbelow, (Draw, Braw), outs, cp, rbp)
    return outs


def lu_panel_deltas_wide(widths, nbelow, DL, DU, BL, BU, cp: int, rbp: int):
    """(ddl, ddu, dbl, dbu) of task-major blocks (see module docstring)."""
    check_panel("lu_panel_deltas_wide", widths, nbelow, (DL, DU), (BL, BU),
                cp, rbp, lanes=False)
    if DL.device.type == "cpu":
        return lu_panel_deltas_plain(widths, nbelow, DL, DU, BL, BU, cp, rbp)
    outs = (torch.empty_like(DL), torch.empty_like(DU),
            torch.empty_like(BL), torch.empty_like(BU))
    launch("panel_wide", "lu", widths, nbelow, (DL, DU, BL, BU), outs, cp,
           rbp)
    return outs
