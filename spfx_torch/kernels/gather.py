"""Batched superwindow gathers from the flat factor.

Port of ``dma_gather2`` / ``dma_gather`` (spfx/kernels/pallas_blocks.py).
Window b of a set is ``L[al(s) : al(s) + win]`` with
``al(s) = (s // ALIGN) * ALIGN`` for its start ``s``, ALIGN = 1024 elements
whatever the dtype: the plan builds every row mask, column map and
extend-add table of an update step against that superwindow base. The
window length ``win`` is any positive number of elements: an update
step's source superwindow is (mp + ALIGN / kp) kp elements, a multiple of
ALIGN only where mp kp is one (1,280 under ``update_tile=16``, or with
``class_min=8, stride_min=0``). A window with ``s < 0`` is a dead task and
comes back as zeros (what the CPU gather with FILL_OR_DROP gives, so the
kernel and the plain version agree bit for bit). A live window must end
inside ``L``: it is never clipped.

float32, float64, complex64 and complex128. The kernel aligns each start
down to ALIGN of the element type it is given, so a complex ``L`` goes in
as itself, with its own element size (8 or 16 bytes), and no start
changes. It moves 16-byte vectors where a window is a whole number of
them, single elements otherwise. Its real view
(``torch.view_as_real(L).reshape(-1)``) would need the starts doubled,
and the kernel's alignment of a doubled start, (2s // ALIGN) * ALIGN, is
not the doubled alignment 2 (s // ALIGN) * ALIGN whenever s % ALIGN >=
ALIGN / 2.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
CUDA kernel (csrc/window_gather.cu) or raises.
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import _cuda
from spfx_torch.plan.schedule import ALIGN

_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def _check(L, starts, win: int, what: str) -> None:
    if L.dtype not in _DTYPES:
        raise TypeError(f"{what}: L must be float32, float64, complex64 or "
                        f"complex128, got {L.dtype}")
    if L.dim() != 1 or not L.is_contiguous():
        raise ValueError(f"{what}: L must be a contiguous 1-D tensor")
    if starts.dtype != torch.int32 or starts.dim() != 1 \
            or not starts.is_contiguous():
        raise ValueError(f"{what}: starts must be a contiguous 1-D int32 "
                         "tensor")
    if starts.device != L.device:
        raise ValueError(f"{what}: starts on {starts.device}, L on "
                         f"{L.device}")
    if win <= 0:
        raise ValueError(f"{what}: window {win} is not positive")


def _aligned(starts):
    """Aligned-down starts (int64); dead windows keep -1."""
    s = starts.to(torch.int64)
    return torch.where(s >= 0, torch.div(s, ALIGN, rounding_mode="floor")
                       * ALIGN, -1)


def _check_bounds(L, starts, win: int, what: str) -> None:
    """Every live aligned window ends inside L (host-side check)."""
    al = _aligned(starts)
    live = al >= 0
    if bool(live.any()) and int(al[live].max()) + win > L.shape[0]:
        raise ValueError(f"{what}: a live window [{int(al[live].max())}, "
                         f"+{win}) ends past the flat array ({L.shape[0]})")


def window_gather_plain(L, starts, win: int):
    """Plain PyTorch version: (B,) starts -> (B, win) windows of L."""
    al = _aligned(starts)
    idx = al.clamp(min=0)[:, None] + torch.arange(win, device=L.device)
    out = L[idx]
    return out.masked_fill_((al < 0)[:, None], 0)


def window_gather2_plain(L, starts_a, win_a: int, starts_b, win_b: int):
    return (window_gather_plain(L, starts_a, win_a),
            window_gather_plain(L, starts_b, win_b))


def _launch(L, starts_a, win_a, starts_b, win_b, what):
    """Launch the CUDA kernel over both sets and count the launch."""
    if not L.is_cuda:
        raise ValueError(f"{what}: unsupported device {L.device}")
    if L.data_ptr() % 16:
        raise ValueError(f"{what}: L must be 16-byte aligned")
    out_a = torch.empty((starts_a.shape[0], win_a), dtype=L.dtype,
                        device=L.device)
    out_b = torch.empty((starts_b.shape[0], win_b), dtype=L.dtype,
                        device=L.device)
    lib = _cuda.lib("window_gather")
    rc = lib.spfx_window_gather2(
        L.data_ptr(), L.shape[0], L.element_size(),
        starts_a.data_ptr(), starts_a.shape[0], win_a, out_a.data_ptr(),
        starts_b.data_ptr(), starts_b.shape[0], win_b, out_b.data_ptr(),
        _cuda.stream_ptr(L.device))
    _cuda.check(rc, what)
    if starts_a.shape[0] + starts_b.shape[0]:
        _cuda.count(what)
    return out_a, out_b


def window_gather2(L, starts_a, win_a: int, starts_b, win_b: int):
    """Two window sets in one launch: ((Ba, win_a), (Bb, win_b)).
    Either set may be empty. On the card a live window that would end past
    ``L`` traps the kernel; on the CPU it raises here."""
    _check(L, starts_a, win_a, "window_gather2")
    _check(L, starts_b, win_b, "window_gather2")
    if L.device.type == "cpu":
        _check_bounds(L, starts_a, win_a, "window_gather2")
        _check_bounds(L, starts_b, win_b, "window_gather2")
        return window_gather2_plain(L, starts_a, win_a, starts_b, win_b)
    return _launch(L, starts_a, win_a, starts_b, win_b, "window_gather2")


def window_gather(L, starts, win: int):
    """One window set: (B, win). The one-set launch of window_gather2's
    kernel."""
    _check(L, starts, win, "window_gather")
    if L.device.type == "cpu":
        _check_bounds(L, starts, win, "window_gather")
        return window_gather_plain(L, starts, win)
    empty = starts[:0]
    return _launch(L, starts, win, empty, ALIGN, "window_gather")[0]
