"""Whole-panel Cholesky and no-pivot LU deltas of one PC bucket, batch in
the last dimension ("lanes" layout).

Port of ``chol_panel_deltas_lanes`` and ``lu_panel_deltas_lanes``
(spfx/kernels/pallas_blocks.py), with their signatures and layout: the
tasks of the bucket run along the last dimension, where the TPU kernels put
them on the vector lanes.

- ``chol_panel_deltas_lanes(widths, nbelow, DrawT, BrawT, cp, rbp)``:
  DrawT (cp, cp, B), BrawT (rbp, cp, B), widths and nbelow (B,) int32;
  returns ``(ddT, dbT)`` in the same layouts.
- ``lu_panel_deltas_lanes(widths, nbelow, DLt, DUt, BLt, BUt, cp, rbp)``:
  returns ``(ddl, ddu, dbl, dbu)``.

They compute what ``panel_wide``'s functions compute (see there), with
cp <= 256, f32 or f64; ``rbp == 0`` returns a (0, cp, B) below delta. A CPU
tensor takes the plain PyTorch version, the task-major one of
``panel_wide`` through a transpose; a CUDA tensor launches the kernel of
csrc/panel_lanes.cu or raises. The kernels are the wide ones' design in
this layout (csrc/panel_blocks.cuh, see ``panel_wide``): 32-column blocks
over explicit inverses of the 32 x 32 diagonal blocks, which they keep in
extra rows of the workspace (32 for Cholesky's L, 64 for LU's L and U),
run as two launches that count as one.
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import panel_wide
from spfx_torch.kernels.panel_wide import check_panel, launch


def to_task_major(t):
    """Lanes layout (rows, cp, B) -> task-major (B, rows, cp) (a view)."""
    return t.permute(2, 0, 1)


def to_lanes(t):
    """Task-major (B, rows, cp) -> lanes layout (rows, cp, B), contiguous."""
    return t.permute(1, 2, 0).contiguous()


def chol_panel_deltas_lanes_plain(widths, nbelow, DrawT, BrawT, cp: int,
                                  rbp: int):
    """Plain version: ``panel_wide.chol_panel_deltas_plain`` transposed."""
    return tuple(to_lanes(t) for t in panel_wide.chol_panel_deltas_plain(
        widths, nbelow, to_task_major(DrawT), to_task_major(BrawT), cp, rbp))


def lu_panel_deltas_lanes_plain(widths, nbelow, DLt, DUt, BLt, BUt, cp: int,
                                rbp: int):
    """Plain version: ``panel_wide.lu_panel_deltas_plain`` transposed."""
    return tuple(to_lanes(t) for t in panel_wide.lu_panel_deltas_plain(
        widths, nbelow, *(to_task_major(t) for t in (DLt, DUt, BLt, BUt)),
        cp, rbp))


def chol_panel_deltas_lanes(widths, nbelow, DrawT, BrawT, cp: int, rbp: int):
    """(ddT, dbT) of lanes-layout blocks (see module docstring)."""
    check_panel("chol_panel_deltas_lanes", widths, nbelow, (DrawT,),
                (BrawT,), cp, rbp, lanes=True)
    if DrawT.device.type == "cpu":
        return chol_panel_deltas_lanes_plain(widths, nbelow, DrawT, BrawT,
                                             cp, rbp)
    outs = (torch.empty_like(DrawT), torch.empty_like(BrawT))
    launch("panel_lanes", "chol", widths, nbelow, (DrawT, BrawT), outs, cp,
           rbp)
    return outs


def lu_panel_deltas_lanes(widths, nbelow, DLt, DUt, BLt, BUt, cp: int,
                          rbp: int):
    """(ddl, ddu, dbl, dbu) of lanes-layout blocks (see module docstring)."""
    check_panel("lu_panel_deltas_lanes", widths, nbelow, (DLt, DUt),
                (BLt, BUt), cp, rbp, lanes=True)
    if DLt.device.type == "cpu":
        return lu_panel_deltas_lanes_plain(widths, nbelow, DLt, DUt, BLt,
                                           BUt, cp, rbp)
    outs = tuple(torch.empty_like(t) for t in (DLt, DUt, BLt, BUt))
    launch("panel_lanes", "lu", widths, nbelow, (DLt, DUt, BLt, BUt), outs,
           cp, rbp)
    return outs
