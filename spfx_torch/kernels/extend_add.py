"""Row extend-add of update rows into a target slab, in place.

Port of ``extend_add_rows`` (spfx/kernels/pallas_blocks.py):
``extend_add_rows(slab, rows, Ef)`` takes the slab (Rs, csp), the update
rows Ef (RE, csp) and their target rows ``rows`` (RE,) int32, and computes

    slab[rows[i]] -= Ef[i]    for every i with rows[i] >= 0;

rows < 0 are dropped, and several rows of Ef may name the same slab row.
It works in place on the slab (a row-major view of the flat factor) and
returns it: the JAX kernel aliases its output onto the slab input. float32
and float64 only.

A CPU tensor takes the plain PyTorch version (``extend_add_rows_plain``,
the masked ``index_add_``), after checking that every live row lies in the
slab; a CUDA tensor launches the kernel of csrc/extend_add.cu or raises.
On the card a live row >= Rs traps the kernel, and the sum order of
repeated rows is not fixed (atomics).
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import _cuda

_DTYPES = (torch.float32, torch.float64)


def _check(slab, rows, Ef) -> None:
    if slab.dtype not in _DTYPES:
        raise TypeError(f"extend_add_rows: slab must be float32 or float64, "
                        f"got {slab.dtype}")
    if Ef.dtype != slab.dtype:
        raise TypeError(f"extend_add_rows: Ef is {Ef.dtype}, slab "
                        f"{slab.dtype}")
    if slab.dim() != 2 or Ef.dim() != 2 or Ef.shape[1] != slab.shape[1]:
        raise ValueError(f"extend_add_rows: slab (Rs, csp) and Ef (RE, csp) "
                         f"expected, got {tuple(slab.shape)} and "
                         f"{tuple(Ef.shape)}")
    if slab.shape[1] < 1:
        raise ValueError("extend_add_rows: csp must be >= 1")
    if not (slab.is_contiguous() and Ef.is_contiguous()):
        raise ValueError("extend_add_rows: slab and Ef must be contiguous")
    if rows.dtype != torch.int32 or rows.shape != (Ef.shape[0],) \
            or not rows.is_contiguous():
        raise ValueError("extend_add_rows: rows must be a contiguous (RE,) "
                         "int32 tensor")
    if not slab.device == Ef.device == rows.device:
        raise ValueError(f"extend_add_rows: slab on {slab.device}, Ef on "
                         f"{Ef.device}, rows on {rows.device}")
    if slab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"extend_add_rows: unsupported device "
                         f"{slab.device}")


def extend_add_rows_plain(slab, rows, Ef):
    """Plain PyTorch version: the masked ``index_add_`` (alpha = -1)."""
    live = rows >= 0
    idx = torch.where(live, rows, 0).to(torch.int64)
    slab.index_add_(0, idx, torch.where(live[:, None], Ef, 0), alpha=-1)
    return slab


def extend_add_rows(slab, rows, Ef):
    """slab -= the live rows of Ef at ``rows``, in place; returns slab."""
    _check(slab, rows, Ef)
    if slab.device.type == "cpu":
        if rows.numel() and int(rows.max()) >= slab.shape[0]:
            raise ValueError(f"extend_add_rows: row {int(rows.max())} is "
                             f"past the slab's {slab.shape[0]} rows")
        return extend_add_rows_plain(slab, rows, Ef)
    total = Ef.shape[0]
    fn = getattr(_cuda.lib("extend_add"), "spfx_extend_add_rows_"
                 + ("f32" if slab.dtype == torch.float32 else "f64"))
    rc = fn(slab.data_ptr(), slab.shape[0], slab.shape[1], rows.data_ptr(),
            total, Ef.data_ptr(), _cuda.stream_ptr(slab.device))
    _cuda.check(rc, "extend_add_rows")
    if total:
        _cuda.count("extend_add_rows")
    return slab
