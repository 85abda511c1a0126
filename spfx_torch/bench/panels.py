"""Batched dense-block panel microbenchmark on the GPU.

Port of spfx/bench/panels.py, the analogue of the reference's Misc/cublas
benchmark (Misc/cublas/cublas_demo.c): 2^16 independent supernodal panel
updates (SYRK n = 64, k = 32 plus GEMM m = n = 64, k = 32), timed under four
batching strategies:

- ``batched_single_call``: one batched einsum pair over the whole task set;
- ``chunked_1024``: a loop over chunks of 1,024 tasks;
- ``custom_kernel``: the hand-written kernel ``syrk_gemm_batched``
  (spfx_torch/kernels/csrc/syrk_gemm.cu);
- ``per_task_loop_extrapolated``: one einsum pair per task over the first
  256 tasks, extrapolated to the whole set.

Data: float32, numpy ``default_rng(0)`` normals, as in the JAX bench. Every
float32 product runs at full float32 (TF32 off). Each strategy's time is
the best of 5 calls after one warm call, each ended by
``torch.cuda.synchronize()``. The GFLOP/s lines go to stderr and ``main``
returns them as a dict. It runs on the CUDA device unless given
``device``; the custom strategy runs its kernel there or the bench fails.

Run: python -m spfx_torch.bench.panels
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from spfx_torch.chol.factorize import resolve_device
from spfx_torch.kernels.mega import matmul_precision
from spfx_torch.kernels.syrk_gemm import syrk_gemm_batched

BATCH = 1 << 16
N, M, K = 64, 64, 32       # ref dims: cublas_demo.h:14-17
CHUNK = 1024
REPS = 5                   # timed calls per strategy, after one warm call
LOOP_TASKS = 256           # tasks the per-task loop runs


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, *args, reps: int = REPS) -> float:
    """Best wall time of ``reps`` calls of ``fn(*args)`` after one warm
    call, each waited for on the device."""
    dev = args[0].device
    fn(*args)
    _sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def strategy_batched(A, B):
    """One batched SYRK + GEMM over the full task set."""
    return (torch.einsum("bnk,bmk->bnm", A, A),
            torch.einsum("bmk,bnk->bmn", B, A))


def strategy_chunked(A, B, chunk: int = CHUNK):
    """A loop over chunks of ``chunk`` tasks, each chunk's products (the
    einsums' batched products) written into the stacked outputs."""
    S = A.new_empty((A.shape[0], A.shape[1], A.shape[1]))
    G = A.new_empty((A.shape[0], B.shape[1], A.shape[1]))
    for i in range(0, A.shape[0], chunk):
        a, b = A[i:i + chunk], B[i:i + chunk]
        torch.bmm(a, a.transpose(1, 2), out=S[i:i + chunk])
        torch.bmm(b, a.transpose(1, 2), out=G[i:i + chunk])
    return S, G


def strategy_custom(A, B):
    """The hand-written batched SYRK + GEMM kernel (strategy 3 of the
    reference, Misc/cublas/cublas_demo.c:236 -> cublas_demo_kernel.cu)."""
    return syrk_gemm_batched(A, B)


def flops(batch: int = BATCH) -> float:
    return batch * (2.0 * N * N * K + 2.0 * M * N * K)


def inputs(batch: int = BATCH, device=None):
    """(A (batch, N, K), B (batch, M, K)) float32 on ``device``, from
    numpy default_rng(0)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((batch, N, K)).astype(np.float32)
    B = rng.standard_normal((batch, M, K)).astype(np.float32)
    return (torch.from_numpy(A).to(device), torch.from_numpy(B).to(device))


def main(device=None, batch: int = BATCH) -> dict:
    """Time the four strategies on ``batch`` tasks; returns {strategy:
    GFLOP/s} and prints the table on stderr."""
    dev = resolve_device(device)
    A, B = inputs(batch, dev)
    fl = flops(batch)
    results = {}
    with matmul_precision("highest"):
        results["batched_single_call"] = fl / _time(strategy_batched, A,
                                                    B) / 1e9
        results["chunked_1024"] = fl / _time(strategy_chunked, A, B) / 1e9
        results["custom_kernel"] = fl / _time(strategy_custom, A, B) / 1e9
        # one call per task on a slice (launch-bound; extrapolated like the
        # reference's strategy-1 loop)
        sub = min(LOOP_TASKS, batch)
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(sub):
            strategy_batched(A[i:i + 1], B[i:i + 1])
        _sync(dev)
        t = (time.perf_counter() - t0) * (batch / sub)
        results["per_task_loop_extrapolated"] = fl / t / 1e9

    base = results["per_task_loop_extrapolated"]
    for k, v in results.items():
        print(f"{k:32s} {v:10.1f} GFLOP/s   x{v / base:8.1f} vs loop",
              file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
