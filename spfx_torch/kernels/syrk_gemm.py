"""Fused batched SYRK + GEMM of small panels.

Port of ``syrk_gemm_batched`` (spfx/kernels/pallas_blocks.py):
``syrk_gemm_batched(A, B)`` takes A (batch, n, k) and B (batch, m, k) and
returns (S, G) in A's dtype, S = A A^T (batch, n, n) and G = B A^T
(batch, m, n), for any n, m, k >= 1; float32 and float64. The JAX kernel's
``slab`` (how many tasks a grid step keeps in VMEM, and with it the rule
batch % slab == 0) has no counterpart: the card has no VMEM model.

A CPU tensor takes the plain PyTorch version (``syrk_gemm_batched_plain``,
the two einsums); a CUDA tensor launches a kernel of csrc/syrk_gemm.cu
(full float32 products, no TF32) or raises. That file has two paths, and
``path`` chooses between them from the shape and the alignment: the bulk
path streams the batch through persistent thread blocks with bulk copies
(n <= 64, n + m <= 128, k <= 32, n and k multiples of a 16-byte vector,
A and B 16-byte aligned); the general path takes every other shape.
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import _cuda


def _check(A, B) -> None:
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"syrk_gemm_batched: A must be float32 or float64, "
                        f"got {A.dtype}")
    if B.dtype != A.dtype:
        raise TypeError(f"syrk_gemm_batched: B is {B.dtype}, A {A.dtype}")
    if A.dim() != 3 or B.dim() != 3 or B.shape[0] != A.shape[0] \
            or B.shape[2] != A.shape[2]:
        raise ValueError(f"syrk_gemm_batched: A (batch, n, k) and B "
                         f"(batch, m, k) expected, got {tuple(A.shape)} and "
                         f"{tuple(B.shape)}")
    if min(A.shape[1], B.shape[1], A.shape[2]) < 1:
        raise ValueError("syrk_gemm_batched: n, m and k must be >= 1")
    if not (A.is_contiguous() and B.is_contiguous()):
        raise ValueError("syrk_gemm_batched: A and B must be contiguous")
    if A.device != B.device:
        raise ValueError(f"syrk_gemm_batched: A on {A.device}, B on "
                         f"{B.device}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"syrk_gemm_batched: unsupported device {A.device}")


BULK_ROWS, BULK_COLS, BULK_K = 128, 64, 32     # the bulk path's largest


def path(n: int, m: int, k: int, itemsize: int, *ptrs: int) -> str:
    """"bulk" if the bulk path takes (n, m, k) in a type of ``itemsize``
    bytes with A and B at addresses ``ptrs``, else "general"."""
    vec = 16 // itemsize
    if (n <= BULK_COLS and n + m <= BULK_ROWS and k <= BULK_K
            and n % vec == 0 and k % vec == 0
            and all(p % 16 == 0 for p in ptrs)):
        return "bulk"
    return "general"


def syrk_gemm_batched_plain(A, B):
    """Plain PyTorch version: the two einsums of the JAX reference."""
    return (torch.einsum("bnk,bmk->bnm", A, A),
            torch.einsum("bmk,bnk->bmn", B, A))


def syrk_gemm_batched(A, B):
    """(S, G) = (A A^T, B A^T), batched (see module docstring)."""
    _check(A, B)
    if A.device.type == "cpu":
        return syrk_gemm_batched_plain(A, B)
    batch, n, k = A.shape
    m = B.shape[1]
    S = A.new_empty((batch, n, n))
    G = A.new_empty((batch, m, n))
    p = path(n, m, k, A.element_size(), A.data_ptr(), B.data_ptr())
    fn = getattr(_cuda.lib("syrk_gemm"), f"spfx_syrk_gemm_{p}_"
                 + ("f32" if A.dtype == torch.float32 else "f64"))
    rc = fn(A.data_ptr(), B.data_ptr(), S.data_ptr(), G.data_ptr(), batch, n,
            m, k, _cuda.stream_ptr(A.device))
    _cuda.check(rc, "syrk_gemm_batched")
    if batch:
        _cuda.count("syrk_gemm_batched")
    return S, G
