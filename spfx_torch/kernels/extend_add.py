"""Row extend-add of update rows into a target slab, in place.

Port of ``extend_add_rows`` (spfx/kernels/pallas_blocks.py):
``extend_add_rows(slab, rows, Ef)`` takes the slab (Rs, csp), the update
rows Ef (RE, csp) and their target rows ``rows`` (RE,) int32, and computes

    slab[rows[i]] -= Ef[i]    for every i with rows[i] >= 0;

rows < 0 are dropped, and several rows of Ef may name the same slab row.
It works in place on the slab (a row-major view of the flat factor) and
returns it: the JAX kernel aliases its output onto the slab input.
float32, float64, complex64 and complex128: on the card a complex slab
row of csp values goes into the same kernel as the real row of 2 csp values
it is in memory (``torch.view_as_real``), with the same row table (the JAX
package subtracts complex rows with XLA's scatter).

``extend_add_rows2(slab_l, slab_u, rows, EL, EU)`` is the same on LU's two
factor arrays at one offset, the port's form of ``extend_add_region_lu``'s
twin regions (spfx/kernels/blocks.py): one walk of the row table subtracts
each live row of EL from slab_l and of EU from slab_u. It counts as one
``extend_add_rows`` launch.

A CPU tensor takes the plain PyTorch version (``extend_add_rows_plain``,
the masked ``index_add_``; the twin, two such calls), after checking that
every live row lies in the slab; a CUDA tensor launches the kernel of
csrc/extend_add.cu or raises. The kernel moves 16-byte vectors where
``vector_path`` says every row starts on a 16-byte boundary, single values
otherwise. On the card a live row >= Rs traps the kernel, and the sum
order of repeated rows is not fixed (atomics).
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import _cuda

_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def _check(slab, rows, Ef) -> None:
    if slab.dtype not in _DTYPES:
        raise TypeError(f"extend_add_rows: slab must be float32, float64, "
                        f"complex64 or complex128, got {slab.dtype}")
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


def vector_path(csp: int, item: int, ptrs) -> bool:
    """Whether a call takes the kernel's 16-byte path: every row of the
    slabs and of E starts on a 16-byte boundary, so csp values of ``item``
    bytes fill whole 16-byte vectors and every pointer of ``ptrs`` is
    16-byte aligned. Otherwise the same kernel moves one value at a time."""
    return csp * item % 16 == 0 and all(p % 16 == 0 for p in ptrs)


def _check_rows(slab, rows) -> None:
    """The CPU's form of the kernel's trap: a live row past the slab."""
    if rows.numel() and int(rows.max()) >= slab.shape[0]:
        raise ValueError(f"extend_add_rows: row {int(rows.max())} is "
                         f"past the slab's {slab.shape[0]} rows")


def _entry(name: str, slab):
    return getattr(_cuda.lib("extend_add"), f"spfx_{name}_"
                   + ("f32" if slab.dtype == torch.float32 else "f64"))


def extend_add_rows_plain(slab, rows, Ef):
    """Plain PyTorch version: the masked ``index_add_`` (alpha = -1)."""
    live = rows >= 0
    idx = torch.where(live, rows, 0).to(torch.int64)
    slab.index_add_(0, idx, torch.where(live[:, None], Ef, 0), alpha=-1)
    return slab


def _real(t):
    """A complex (R, c) tensor as the real (R, 2c) view of its memory."""
    return torch.view_as_real(t).view(t.shape[0], 2 * t.shape[1]) \
        if t.is_complex() else t


def _apply(rows, pairs) -> None:
    """slab -= the live rows of E at ``rows`` for each (slab, E) of
    ``pairs`` (one pair, or LU's two at one offset), checked by the caller:
    the plain version on the CPU, one launch of the kernel on the card
    (complex through the real views)."""
    slab = pairs[0][0]
    if slab.device.type == "cpu":
        _check_rows(slab, rows)
        for s, e in pairs:
            extend_add_rows_plain(s, rows, e)
        return
    pairs = [(_real(s), _real(e)) for s, e in pairs]
    slab = pairs[0][0]
    name = "extend_add_rows" if len(pairs) == 1 else "extend_add_rows2"
    total = rows.shape[0]
    vec = vector_path(slab.shape[1], slab.element_size(),
                      [t.data_ptr() for p in pairs for t in p])
    rc = _entry(name, slab)(
        *(s.data_ptr() for s, _ in pairs), slab.shape[0], slab.shape[1],
        rows.data_ptr(), total, *(e.data_ptr() for _, e in pairs), int(vec),
        _cuda.stream_ptr(slab.device))
    _cuda.check(rc, name)
    if total:
        _cuda.count("extend_add_rows")


def extend_add_rows(slab, rows, Ef):
    """slab -= the live rows of Ef at ``rows``, in place; returns slab."""
    _check(slab, rows, Ef)
    _apply(rows, [(slab, Ef)])
    return slab


def extend_add_rows2(slab_l, slab_u, rows, EL, EU):
    """The twin form, for LU's two factor arrays at one offset: slab_l -=
    the live rows of EL and slab_u -= those of EU, both at ``rows``, in
    place, in one launch on the card (one walk of the row table); returns
    (slab_l, slab_u)."""
    _check(slab_l, rows, EL)
    _check(slab_u, rows, EU)
    if slab_u.shape != slab_l.shape or EU.shape != EL.shape:
        raise ValueError(f"extend_add_rows2: slabs {tuple(slab_l.shape)} "
                         f"and {tuple(slab_u.shape)}, E {tuple(EL.shape)} "
                         f"and {tuple(EU.shape)}: each pair must match")
    if slab_u.dtype != slab_l.dtype:
        raise TypeError(f"extend_add_rows2: slab_l is {slab_l.dtype}, "
                        f"slab_u {slab_u.dtype}")
    _apply(rows, [(slab_l, EL), (slab_u, EU)])
    return slab_l, slab_u
