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
reads the operands at their own strides, so the transposed views the
walks pass need no copy.
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


def bmm_bf16x3(a, b):
    """(batch, m, n) = a (batch, m, k) @ b (batch, k, n), float32, as three
    bf16 passes (see module docstring)."""
    _check(a, b)
    if a.device.type == "cpu":
        return bmm_bf16x3_plain(a, b)
    batch, m, k = a.shape
    n = b.shape[2]
    c = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    rc = _cuda.lib("bmm_bf16x3").spfx_bmm_bf16x3_f32(
        a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(), c.data_ptr(),
        batch, m, n, k, _cuda.stream_ptr(a.device))
    _cuda.check(rc, "bmm_bf16x3")
    if batch and m and n:
        _cuda.count("bmm_bf16x3")
    return c
