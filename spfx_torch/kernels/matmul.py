"""The batched matrix products of the factorization and solve walks, at the
JAX matmul precision in force.

``bmm(a, b)`` is ``torch.bmm`` unless the active mode (set by
``mega.matmul_precision``, read here with ``mode()``) is ``"high"`` and both
operands are float32: then it is ``bmm_bf16x3(a, b)``, JAX's "high"
precision (bf16x3, spfx/utils/config.py), the product as three bf16
passes:

- each float32 value x is split into hi = bf16(x) and lo = bf16(x - hi),
  both rounded to nearest;
- C = hi.hi + hi.lo + lo.hi, summed in float32 (about 2^-16 of sum |a||b|
  per entry, where full float32 is about 2^-24 k and one bf16 pass 2^-8).

"high" leaves float64 and complex products at their full precision, as
XLA's precision config does: those go to ``torch.bmm`` in every mode. The
other modes map onto torch's float32 matmul setting (``mega._PRECISION``):
"highest" / "float32" full float32, "default" / "bfloat16" TF32.

A CPU tensor takes the plain version ``bmm_bf16x3_plain`` (the same split
in torch, three float32 ``bmm``s, also the kernel's oracle); a CUDA
tensor launches the kernel of csrc/bmm_bf16x3.cu or raises. The kernel
reads each operand with k unit-stride, 16-byte aligned, every stride that
is used a multiple of 4 values (``fits``): the update steps' C = G H^T
(G a fresh gather, H^T a transposed view of a contiguous H) as they lie.
Any other operand (the panel path's transposed and offset views, the
solves') is first copied once into that layout (``fast_layout``); ``path``
says which of the two a call takes, from shapes, strides and alignment
alone. The kernel's tile is ``fast_tile``'s, fitted to m and n, and its
work (``fast_work``) about the tensor cores' grain: m up to 16, n up to
a warp's 8 or 16 columns, k up to 16.
"""

from __future__ import annotations

import contextlib

import torch

from spfx_torch.kernels import _cuda

_mode = "highest"           # the JAX precision the walk is running at


def mode() -> str:
    """The active JAX matmul precision of the walks' products."""
    return _mode


@contextlib.contextmanager
def precision(name: str):
    """Products at JAX precision ``name`` inside the block (the torch
    setting is ``mega.matmul_precision``'s); restored afterwards."""
    global _mode
    old, _mode = _mode, name
    try:
        yield
    finally:
        _mode = old


def bmm(a, b):
    """a @ b, batched, at the active precision (see module docstring)."""
    if _mode == "high" and a.dtype == torch.float32 \
            and b.dtype == torch.float32:
        return bmm_bf16x3(a, b)
    return torch.bmm(a, b)


def _split(x):
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def bmm_bf16x3_plain(a, b):
    """Plain PyTorch version: hi.hi + hi.lo + lo.hi, three float32 bmm.
    Every product of two bf16 values is exact in float32, and bf16 values
    pass TF32's rounding unchanged, so torch's float32 mode does not
    change the result beyond the order of the sums."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return torch.bmm(ah, bh) + torch.bmm(ah, bl) + torch.bmm(al, bh)


def _check(a, b) -> None:
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"bmm_bf16x3: operands must be float32, got "
                        f"{a.dtype} and {b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"bmm_bf16x3: (batch, m, k) @ (batch, k, n) "
                         f"expected, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"bmm_bf16x3: a on {a.device}, b on {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bmm_bf16x3: unsupported device {a.device}")


SMS = 132                   # the H100 SXM's streaming multiprocessors
MAX_TILE_M = 160            # the kernel's tallest row tile


def _used(stride: int, size: int) -> bool:
    """Whether a stride is a multiple of 4 values where the kernel uses it
    (a dimension of size 1 never steps)."""
    return size <= 1 or stride % 4 == 0


def fits(x) -> bool:
    """Whether the kernel reads x (batch, r, k) as it lies: k unit-stride
    (or at most one value), 16-byte aligned, the batch and row strides
    multiples of 4 values where they step."""
    batch, r, k = x.shape
    return (x.stride(2) == 1 or k <= 1) and x.data_ptr() % 16 == 0 \
        and _used(x.stride(0), batch) and _used(x.stride(1), r)


def fast_layout(x):
    """x (batch, r, k) as the kernel reads it: x itself where it ``fits``,
    else one copy with k unit-stride and each row padded to a multiple of
    4 values."""
    if fits(x):
        return x
    batch, r, k = x.shape
    out = x.new_empty((batch, r, -(-k // 4) * 4))[:, :, :k]
    out.copy_(x)
    return out


def path(a, b) -> str:
    """"fast" where a (batch, m, k) and b (batch, k, n) are read as they
    lie, "copy" where one of them is copied first (see the module
    docstring)."""
    return "fast" if fits(a) and fits(b.transpose(1, 2)) else "copy"


def fast_tile(batch: int, m: int, n: int) -> tuple:
    """(tile_m, tile_n) of the kernel. tile_m: m rounded up to 16 rows
    (one template per multiple of 16 up to 160); a taller m takes the
    tallest multiple of 16 up to 160 whose row tiles pad it within 10% of
    m rounded up to 16. tile_n: 64 columns where that still gives every SM
    a block, else 32.

    A pure function of the shape, so that the CPU tests hold the choice:
    ``SMS`` is the H100 SXM's count, the port's one target card, not read
    from the device. The 16-row grain is what the UT products need: a
    32-row grain would pad m = 136 to 160 rows (18%), where 16 pads it to
    144 (6%)."""
    m16 = max(-(-m // 16) * 16, 16)
    tm = m16 if m16 <= MAX_TILE_M else max(
        t for t in range(16, MAX_TILE_M + 1, 16)
        if -(-m // t) * t <= 1.1 * m16)
    blocks = batch * -(-m // tm) * -(-n // 64)
    return tm, 64 if blocks >= SMS else 32


def fast_work(batch: int, m: int, n: int, k: int) -> int:
    """Multiply-adds the kernel's tensor-core fragments do, per pass,
    walked as the kernel walks them: every row tile whole; in each column
    tile, the columns of the warps (8 or 16 columns each) that hold any
    column below n; k rounded up to 16."""
    tm, tn = fast_tile(batch, m, n)
    per_warp = tn // 4
    cols = sum(-(-min(tn, n - c) // per_warp) * per_warp
               for c in range(0, n, tn))
    return batch * -(-m // tm) * tm * cols * -(-k // 16) * 16


def bmm_bf16x3(a, b):
    """(batch, m, n) = a (batch, m, k) @ b (batch, k, n), float32, as three
    bf16 passes (see module docstring)."""
    _check(a, b)
    if a.device.type == "cpu":
        return bmm_bf16x3_plain(a, b)
    batch, m, k = a.shape
    n = b.shape[2]
    c = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    if not (batch and m and n):
        return c
    a = fast_layout(a)
    b = fast_layout(b.transpose(1, 2)).transpose(1, 2)
    rc = _cuda.lib("bmm_bf16x3").spfx_bmm_bf16x3_fast_f32(
        a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
        b.stride(2), c.data_ptr(), batch, m, n, k, *fast_tile(batch, m, n),
        _cuda.stream_ptr(a.device))
    _cuda.check(rc, "bmm_bf16x3")
    _cuda.count("bmm_bf16x3")
    return c
