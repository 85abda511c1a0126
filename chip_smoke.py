#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spfx_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which raises on a failed check (the script then exits
non-zero):

1. card: nvidia-smi's name and power limit, torch's device name;
2. build: the CUDA kernels from spfx_torch/kernels/csrc (eleven sources,
   one nvcc each, started together), timed;
3. kernels: every window_gather2 and potrf_inv call of the 48^3 f32
   Cholesky plan (the starts of its UT buckets, the 32x32 diagonal blocks
   of its PC buckets after assembly), in f32 and f64, against the plain
   PyTorch versions on the card; then times of kernel, plain version and
   library call at the main path's largest call, and each kernel's bound;
3b. the same for getrf_inv over every call of the 48^3 f32 LU plan (the
   32x32 diagonal blocks of the LU fronts of its PC buckets, built from
   the assembled Lx and Ux), plus seeded blocks at nb = 16 and 8 and at
   nb = 32 scaled by 2^80; its times also per launch at B = 1 and 256;
3c. the four whole-panel kernels (chol/lu_panel_deltas_lanes/wide) at
   every PC step of the 48^3 plans (395 calls each; the panels taken from
   the assembled arrays), in f32 and f64, against their plain versions,
   with L11 L11^T = D, L21 L11^T = B (Cholesky) and L11 U11 = D,
   L21 U11 = BL, U12^T L11^T = BU (LU) checked on the live part, and all
   four kernels at five seeded edge calls of their blocking (both
   families share one blocked design, csrc/panel_blocks.cuh); then times
   of kernel, plain version and library calls at the largest call by work,
   each kernel's bound, the whole path's calls in one graph and the
   library calls over the path (LU's eagerly, since lu_factor_ex cannot
   be captured, with their device time from torch.profiler beside);
3d. extend_add_rows at every UT step of the 48^3 Cholesky plan (1,126
   calls: each step's row table and slab view of a seeded flat array, E
   seeded in the step's shape), in f32 and f64, against the plain version;
   every row on one slab row (integer values, exact) and every row dropped
   (slab untouched); times of kernel, plain version and the masked
   index_add_ at the largest call, its bound, and the whole path's calls
   in one graph; then window_gather2, window_gather, extend_add_rows and
   extend_add_rows2 at every UT step again on complex64 and complex128
   flat arrays, against their plain versions (complex goes through the
   same two kernels);
3e. cholesky_small_batched at every c from 1 to 32 at batches 1, 3 and
   133, at (64, 8), c = 1, 7, 16 and (65,536, 32), f32 and f64, NaN, +Inf
   or 1e3 above the diagonal, against the plain version, with L L^T = D,
   exact zeros above the diagonal and L bit for bit the factor of the
   input with zeros there; unaligned inputs (the single-value path) bit
   for bit the aligned ones' factors; a negative pivot's NaN where the
   plain version has them; times against torch.linalg.cholesky_ex at
   (65,536, 32);
3f. potrf_inv_c (csrc/potrf_inv_c.cu) and getrf_inv_c at every
   diagonal-block call of the complex64 48^3 plans (the magnetic
   Laplacian, ``magnetic_laplacian``, and its unsymmetric variant, on the
   48^3 analysis), complex64 and complex128, against the plain versions,
   with L L^H = D and L U = D and the inverses checked; seeded blocks of
   widths 0, 1, 7, 8, 9, 31 and 32 in one call and blocks scaled by
   2^40, 2^70 and 2^-70, held row by row and column by column; times of
   kernel, plain version and library calls at the largest call, and their
   bounds; both kernels also at B = 1 (the plan's widest block) and in
   complex128 at the same calls (getrf_inv_c: csrc/getrf_inv_c.cu);
3g. bmm_bf16x3 (csrc/bmm_bf16x3.cu) at the product shape of every UT step
   of the 48^3 f32 plans, each read as it lies, and at a transposed and
   an unaligned operand, each copied into the kernel's layout first,
   against
   bmm_bf16x3_plain (tolerance from k), the plain version against float64
   within the bf16x3 error model and below one bf16 pass's error; times
   against torch.bmm at full float32 and at TF32, and its bound, at the
   largest product and over all of them;
4. Cholesky main path: spfx_torch.Cholesky(laplacian_3d(48)) with the
   default Config, whose engine "mega" captures the walk into a CUDA
   graph at the first factorization (an eager warm-up first) and replays
   it after: the capture's launch counts against the plan (window_gather2
   once per UT step and factor array, extend_add_rows once per UT step:
   LU's twin entry takes both arrays), the first factorization's at
   twice that (warm-up and capture), and each of 5 steady factorizations
   one replay with the counters unmoved; the first factorization split
   into warm-up, capture and first replay, the steady wall (median),
   entry_values' host time, GFLOP/s, peak memory and the memory held
   after the first factorization; the graph factor against the eager
   walk's (trace_fn, what engine="calls" runs) on the same entry values,
   within 1e-5 (f32) or 1e-12 (f64) of each array's largest entry; the
   refined solve's scaled residual (<= 1e-12); and (the "graph" report)
   one replay's profiled device time against the eager walk's, the
   device-busy share, the replay between CUDA events, the first factor
   bit for bit unchanged by factorizing 2A on the same context, and
   run_repeat's slope between 1 and 4 replays; (the "solve" report) the
   same factor's device solve (solve_backend="device"): its time beside
   the host solve's, its unrefined residual and distance from the host
   solution, its refined residual (<= 1e-12);
4b. LU main path: spfx_torch.LU(laplacian_3d(48)) with the default Config,
   the same checks and reports;
4c. the same two factorizations with SPFX_PANEL_KERNEL=lanes, then =wide:
   a graph per mode, the capture's launches against the route-aware
   prediction (every PC step one launch of the route's kernel), the graph
   against the eager walk;
4j. the recorder's step stamps (spfx_torch.utils.instrument), both kinds
   at 48^3 f32 with the default Config: the stamps captured in phase 4's
   graph, summed over a replay (assembly, every level's update and panel
   buckets), within 3% of CUDA events around that replay (median of 3);
   the factor against a factor from a graph captured with the recorder
   off (which has no stamps), within 1e-5 of its largest entry, beside
   the distance between two replays of one graph (the walk's atomics
   order its sums anew each replay); the stamped and unstamped replays
   between CUDA events (medians of 5, in turns) and the solve graph's
   capture times kept by MegaSolver;
4d. the non-default bucket kinds and engines, Cholesky and LU in f32:
   Config(update_tile=0) (UC buckets) and Config(layout="rowwin") with the
   mega engine at 48^3 on the 48^3 analysis, and
   Config(layout="rowwin", engine="fused") (one graph per chunk of
   levels) at 32^3: the same checks as phase 4 (the capture's launches
   against the plan's prediction by bucket kind: one extend_add_rows per
   UC step, no window_gather2; the graph factor against the eager walk;
   the refined residual), one replay between CUDA events, for the mega
   engine the graph report, and for rowwin with the mega engine the
   device solve report;
4e. complex64 at 48^3 with the default Config but the dtype: a Cholesky of
   the magnetic Laplacian and an LU of its unsymmetric variant, the
   checks of phase 4 (the capture's launches against the complex plan's
   prediction, potrf_inv_c / getrf_inv_c in place of the real kernels;
   the graph against the eager walk within 1e-5; the refined residual
   through the device solve, complex right-hand side) and the graph
   report;
4f. update_precision="high" at 48^3 f32, both kinds: the capture's
   bmm_bf16x3 launches (one per UT step, LU's two), the graph against the
   eager walk, the factor within 1e-3 of the default precision's (phase
   4), the refined residual, and the steady wall beside the default's;
4g. the stage-streamed engines, StreamingCholesky and StreamingLU at 48^3
   f32 with the default Config and 2^24 values a stage: the stage count,
   the first factorization's launches (every stage's walk warmed up and
   captured) against the plan's prediction, steady factorizations (one
   replay a stage, counters unmoved) with upload, walk and download times,
   the peak device memory above the start below the in-core path's (4,
   4b), the factor within 1e-5 of the in-core graph factor's largest
   entry, the refined residual (<= 1e-12);
4h. the ALS/iALS recommender at als_bench's full width (rank 64, caps
   256 / 512, 512-row chunks, f32) on the "20m" synthetic shape with a
   fifth of its users (27,600 x 27,000, average degree 144; generated in
   a spawned worker from phase 3 on): generation time, the slope per
   iteration and examples/s, U and V finite with zero padding rows,
   full_implicit_loss below the seeded tables', recall@20 and NDCG@10
   beside the popularity baseline, recall@20 above it once the caps hold
   every interaction (a second model: the bench's item cap of 512 drops
   the most popular items' interactions), peak memory, one iteration's
   device-busy share;
4i. the multi-device engines at full width in a world of one NCCL rank
   (spfx_torch.dist; a file rendezvous in a temporary directory):
   ShardedCholesky, ShardedLU, SubtreeCholesky and SubtreeLU at 48^3 f32
   with the default Config on the 48^3 analysis: the first and three
   steady factorizations' launches by kernel (rows 1, 3 or 4 and 5:
   window_gather2, potrf_inv or getrf_inv, extend_add_rows) against the
   plans' prediction (the subtree engine's local phase is a MegaRunner
   graph: captured at the first, replayed after), their all-reduces by
   count and bytes against the plan's, the first and steady walls, the
   peak memory rise beside the in-core path's, the refined residual
   (<= 1e-12) and the factor within 1e-5 of the in-core graph factor's
   largest entry (phases 4 and 4b; flat for the sharded engines, through
   L_sparse / LU_sparse for the subtree ones); then ALSModel over the
   group's mesh on phase 4h's data and config, its fit_steps captured
   over NCCL: its slope per iteration beside 4h's and its tables after
   the same iterations within 1e-5 of 4h's;
5. f64: laplacian_3d(32) with Config(dtype="float64"), residual <= 1e-12,
   with the device solve report;
5b. f64 LU at 32^3 with unsymmetric values (every entry above the diagonal
   of laplacian_3d(32) scaled by a factor from U[0.25, 1]), residual
   <= 1e-12, with the device solve report;
5c. the 32^3 f64 Cholesky under lanes and the unsymmetric 32^3 f64 LU
   under wide, residual <= 1e-12 without refinement;
5d. complex128 at 32^3, both kinds (magnetic Laplacian, its unsymmetric
   variant): residual <= 1e-12, with the device solve report;
6. card against CPU: laplacian_3d(12) in f64, flat factors within 1e-10;
6b. the same for LU, on the unsymmetric 12^3 matrix, both flat factors;
6c. the same for both kinds under SPFX_PANEL_KERNEL=lanes, wide and mixed;
6f. the same for both kinds under the three configs of phase 4d;
6g. the same in complex128 on the magnetic Laplacians under the default
   config and phase 4d's three (within 1e-10), and matmul_precision="high"
   in f32 (within 1e-4: both sides bf16x3, summed in other orders);
6h. window_gather2 and window_gather at windows that are not a multiple of
   1024 elements (1,280, 1,536, and 1,027 or 1,025, no whole number of
   16-byte vectors), every dtype, a dead window in each set, bit for bit
   against the plain versions; then the two configs of the JAX package's
   tests whose plans build such windows (update_tile=16, update_small=8;
   ordering="nd", class_min=8, stride_min=0), both kinds, f64 and f32,
   card against CPU (within 1e-10 and 1e-4), each plan checked to hold
   such a window;
6i. the recommender on the "100k" shape at rank 64, card against CPU:
   fit_steps(2) in f64 (within 1e-10) and under matmul_precision="high"
   in f32 (within 1e-4); one f64 user sweep against the dense oracle; the
   batched Cholesky with NaN above the diagonal; then StreamingCholesky and
   StreamingLU at 12^3 f64 (2^15 values a stage), card against CPU within
   1e-10;
6j. two ranks on the one card (NCCL refuses two ranks on one GPU, so two
   spawned processes join a gloo group over CUDA tensors on cuda:0): the
   four multi-device engines at 16^3 f64 (LU on unsymmetric values) and
   the recommender's "100k" shape at rank 64, f64 fit_steps(2); every
   rank's factors and tables within 1e-10 of the CPU's and of the card's
   in the world of one NCCL rank (phase 4i's group); every rank's launch
   counters non-zero for each kernel of the path;
6e. the surfaces at 12^3: the CLI (both kinds, factors saved), the saved
   factors loaded onto the card and solved (host and device solve), and
   the profile scope's trace; the CLI on complex .mtx files (complex64,
   both kinds) and their complex checkpoints loaded onto the card and
   solved;
6d. syrk_gemm_batched against its plain version at seeded shapes that
   reach both of its paths, f32 and f64; then the panel bench,
   spfx_torch.bench.panels.main() at its full size (2^16
   tasks): the four strategies' GFLOP/s, its launches (a path of its own),
   the custom kernel's S and G against the einsum strategy, and the times
   of syrk_gemm_batched, its plain version and a torch.bmm pair, with its
   bound;
7. the ``kernels`` JSON line (fourteen kernels), the nvidia-smi line, then
   the final ``ok`` JSON line.

``--profile`` adds a torch.profiler pass over one 48^3 factorization (a
graph replay) of each kind under each route (default, lanes, wide),
prints each one's device time, and writes their kernel tables to
chiprun_out/chip_smoke_profile{,_lu}{,_lanes,_wide}.txt.

It needs one CUDA device and the spfx_torch package next to it; without
either it prints no result and exits 2.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
L2_BYTES = 50e6                    # H100 L2 cache, same source
PEAK_FLOPS = {"float32": 67e12,    # non-tensor-core rates, same source
              "float64": 34e12}
GRID = 48                          # the headline matrix, laplacian_3d(48)
GRID_F64 = 32                      # the double-precision cases
GRID_CPU = 12                      # card against CPU
SMALL_BATCH = 65536                # cholesky_small_batched's (batch, 32)
# phase 4d's and 6f's configs: UC buckets, the rowwin layout (mega engine),
# the rowwin layout under the fused engine
LAYOUT_CONFIGS = (("uc", dict(update_tile=0)),
                  ("rowwin", dict(layout="rowwin")),
                  ("rowwin_fused", dict(layout="rowwin", engine="fused")))


_LOG = []           # the open log file, once main() has started


def log(*a):
    """Print a line, and keep it in chiprun_out/chip_smoke.log: the whole
    run's lines, which the end of the output alone may not hold."""
    print(*a, flush=True)
    for fh in _LOG:
        print(*a, file=fh, flush=True)


def fail(msg: str):
    raise AssertionError(msg)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

def time_ms(fn, reps: int = 10, rounds: int = 5, graph: bool = True) -> float:
    """Median device time of one call of ``fn``: ``reps`` calls captured in
    one CUDA graph, the graph replayed ``rounds`` times between CUDA events.
    Replaying a graph keeps the host's launch cost out of the time, which
    for these small launches is larger than the kernels themselves.
    ``graph=False`` times ``reps`` eager calls between the events instead,
    for a call that cannot be captured (its host launches then count)."""
    import torch
    if not graph:
        for _ in range(3):
            fn()
        ts = []
        for _ in range(rounds):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / reps)
        return statistics.median(ts)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    del g
    return statistics.median(ts)


def bound(nbytes: float, ops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of the type."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def gather_calls(plan, dev):
    """(starts_a, win_a, starts_b, win_b) of every UT step of the plan."""
    from spfx_torch.plan.schedule import ALIGN
    out = []
    for lp in plan.levels:
        for ub in lp.updates:
            t = ub.to(dev)
            ext = ALIGN // ub.kp
            out.append((t[3], (ub.mp + ext) * ub.kp, t[4],
                        ub.tgt_cpos.shape[1] * ub.kp))
    return out


def gather_bytes(call, itemsize: int) -> float:
    sa, wa, sb, wb = call
    live = int((sa >= 0).sum()) * wa + int((sb >= 0).sum()) * wb
    total = sa.shape[0] * wa + sb.shape[0] * wb
    return float((live + total) * itemsize + 4 * (sa.shape[0] + sb.shape[0]))


def max_diff(x, y) -> float:
    return float((x - y).abs().max()) if x.numel() else 0.0


def check_gathers(plan, dtype: str, dev, gen):
    """Every window_gather2 call of the plan against the plain version,
    bit for bit, on a seeded flat array; the one-set window_gather too.
    Returns the flat array, the calls and the largest |kernel - plain| of
    each wrapper (0 when they agree bit for bit)."""
    import torch
    from spfx_torch.kernels import gather
    td = getattr(torch, dtype)
    L = torch.randn(plan.storage, generator=gen, device=dev, dtype=td)
    calls = gather_calls(plan, dev)
    err2 = err1 = 0.0
    for sa, wa, sb, wb in calls:
        ka, kb = gather.window_gather2(L, sa, wa, sb, wb)
        pa, pb = gather.window_gather2_plain(L, sa, wa, sb, wb)
        err2 = max(err2, max_diff(ka, pa), max_diff(kb, pb))
        if not (torch.equal(ka, pa) and torch.equal(kb, pb)):
            fail(f"window_gather2 {dtype} differs from its plain version")
        k1 = gather.window_gather(L, sa, wa)
        err1 = max(err1, max_diff(k1, pa))
        if not torch.equal(k1, pa):
            fail(f"window_gather {dtype} differs from its plain version")
    # an empty side on either hand
    sa, wa, sb, wb = calls[0]
    for a, b in ((sa[:0], sb), (sa, sb[:0])):
        ka, kb = gather.window_gather2(L, a, wa, b, wb)
        pa, pb = gather.window_gather2_plain(L, a, wa, b, wb)
        if not (torch.equal(ka, pa) and torch.equal(kb, pb)):
            fail(f"window_gather2 {dtype} with an empty side differs")
    torch.cuda.synchronize()
    return L, calls, {"window_gather2": err2, "window_gather": err1}


# the configs of the JAX package's tests whose plans build UT source
# windows that are not a multiple of 1024 elements ((mp + 1024/kp) kp with
# mp kp not a multiple of 1024): tests/test_mega.py's
# test_tiled_tall_task_tiles and tests/test_cholesky.py's
# test_class_min_coarse_classes
ODD_WINDOW_CONFIGS = (("tall tiles", dict(update_tile=16, update_small=8)),
                      ("fine classes", dict(ordering="nd", class_min=8,
                                            stride_min=0)))
# (win_a, win_b) by dtype: 1,280 and 1,536 (the plans' windows), then a
# length that is no whole number of 16-byte vectors beside 1,280
ODD_WINDOWS = {"float32": ((1280, 1536), (1027, 1280)),
               "float64": ((1280, 1536), (1025, 1280)),
               "complex64": ((1280, 1536), (1025, 1280)),
               "complex128": ((1280, 1536), (1027, 1280))}


def check_odd_windows(dev, gen):
    """window_gather2 and window_gather against their plain versions, bit
    for bit, at the windows of ``ODD_WINDOWS`` in every dtype, each set
    with a dead window and live starts off the 1024-element grid."""
    import torch
    from spfx_torch.kernels import gather
    for dtype, pairs in ODD_WINDOWS.items():
        L = torch.randn(64 * 1024, generator=gen, device=dev,
                        dtype=getattr(torch, dtype))
        sa = torch.tensor([0, 1500, -1, 9 * 1024 + 7, 40 * 1024],
                          dtype=torch.int32, device=dev)
        sb = torch.tensor([-3, 2048, 30 * 1024 + 1023], dtype=torch.int32,
                          device=dev)
        for wa, wb in pairs:
            ka, kb = gather.window_gather2(L, sa, wa, sb, wb)
            pa, pb = gather.window_gather2_plain(L, sa, wa, sb, wb)
            k1 = gather.window_gather(L, sa, wa)
            if not (torch.equal(ka, pa) and torch.equal(kb, pb)
                    and torch.equal(k1, pa)):
                fail(f"window_gather2 {dtype} at windows ({wa}, {wb}) "
                     "differs from its plain version")
    torch.cuda.synchronize()


def narrow_potrf_calls(dev, gen):
    """potrf_inv at nb = 16 and 8 (panels narrower than the default
    stride_min), seeded SPD blocks with junk above the diagonal."""
    import torch
    out = []
    for nb in (16, 8):
        X = torch.randn(64, nb, nb, generator=gen, device=dev,
                        dtype=torch.float64)
        D = X @ X.transpose(1, 2) + nb * torch.eye(nb, device=dev,
                                                   dtype=torch.float64)
        D = D + torch.triu(torch.full_like(D, 1e3), 1)
        w = torch.randint(0, nb + 1, (64,), generator=gen, device=dev,
                          dtype=torch.int32)
        out.append((w, D.float()))
    return out


def edge_potrf_calls(dev):
    """Two seeded potrf_inv calls at nb = 32 (drawn from a generator of
    their own, so that the other checks' draws stay as they were): blocks
    of widths 0, 1, 7, 8, 9, 31 and 32, so that a launch's widest block is
    not its first and the kernel's early stops fall before, on and after a
    multiple of 8; and one ill-conditioned block S A S, A = X X^T + 32 I,
    S = diag(2^(-44 i / 31)), whose L^{-1} entries pass 2^40 (its rows
    and columns span 2^44 in scale, so ``check_potrf`` holds it by row and
    column: ``local``)."""
    import torch
    own = torch.Generator(device=dev)
    own.manual_seed(32)
    f64 = dict(device=dev, dtype=torch.float64)
    X = torch.randn(8, 32, 32, generator=own, **f64)
    D = X @ X.transpose(1, 2) + 32 * torch.eye(32, **f64)
    junk = torch.triu(torch.full((32, 32), 1e3, **f64), 1)
    S = torch.diag(2.0 ** (-44.0 * torch.arange(32, **f64) / 31))
    w = torch.tensor([0, 1, 7, 8, 9, 31, 32], device=dev, dtype=torch.int32)
    return [(w, (D[:7] + junk).float()),
            (w[-1:].contiguous(), (S @ D[7:] @ S + junk).float())]


def narrow_getrf_calls(dev, gen):
    """getrf_inv at nb = 16 and 8: seeded diagonally dominant blocks with
    both triangles filled, wrel covering 0, 1, nb - 1 and nb; then the
    same at nb = 32 scaled by 2^80, beyond the range of the fast division
    that U^{-1} takes in f32, so that the kernel forms it again with the
    IEEE division (drawn from a generator of its own, so that the other
    checks' draws stay as they were)."""
    import torch
    out = []
    own = torch.Generator(device=dev)
    own.manual_seed(80)
    for nb in (16, 8, 32):
        g = own if nb == 32 else gen
        D = torch.randn(64, nb, nb, generator=g, device=dev,
                        dtype=torch.float64)
        D = D + torch.diag_embed(D.abs().sum(2) + 1.0)
        if nb == 32:
            D = D * 2.0 ** 80
        w = torch.randint(0, nb + 1, (64,), generator=g, device=dev,
                          dtype=torch.int32)
        w[:4] = torch.tensor([0, 1, nb - 1, nb], dtype=torch.int32)
        out.append((w, D.float()))
    return out


def potrf_work(wrel, nb: int, item: int):
    """(bytes, operations) that potrf_inv must spend on one call: each
    block reads the lower triangle of its live w x w part, w(w+1)/2
    values, and its wrel entry, and writes L and L^{-1}, 2 nb^2 values;
    the Cholesky and the triangular inverse take w^3/3 flops each."""
    w = wrel.clamp(0, nb).double()
    nbytes = (float((w * (w + 1) / 2).sum()) * item
              + 2.0 * wrel.shape[0] * nb * nb * item + 4.0 * wrel.shape[0])
    return nbytes, float((2.0 / 3.0 * w ** 3).sum())


def getrf_work(wrel, nb: int, item: int):
    """(bytes, operations) that getrf_inv must spend on one call: each
    block reads its live w x w part (both triangles), w^2 values, and its
    wrel entry, and writes L, U, L^{-1} and U^{-1}, 4 nb^2 values; the LU
    takes 2/3 w^3 flops and the two triangular inverses w^3/3 each."""
    w = wrel.clamp(0, nb).double()
    nbytes = (float((w * w).sum()) * item
              + 4.0 * wrel.shape[0] * nb * nb * item + 4.0 * wrel.shape[0])
    return nbytes, float((2.0 / 3.0 * w ** 3 + 2.0 * w ** 3 / 3.0).sum())


def chol_panel_work(widths, nbelow, cp: int, rbp: int, item: int):
    """(bytes, operations) that one whole-panel Cholesky call must spend:
    each task reads the lower triangle of its live w x w window,
    w(w+1)/2 values, its live below block, nb*w values, and its widths and
    nbelow entries, and writes both deltas in full, cp^2 + rbp*cp values;
    the factorization takes w^3/3 flops and the below solve nb*w^2."""
    w = widths.clamp(0, cp).double()
    nb = nbelow.clamp(0, rbp).double()
    B = widths.shape[0]
    nbytes = (float((w * (w + 1) / 2 + nb * w).sum()) * item
              + B * (cp * cp + rbp * cp) * item + 8.0 * B)
    return nbytes, float((w ** 3 / 3.0 + nb * w * w).sum())


def lu_panel_work(widths, nbelow, cp: int, rbp: int, item: int):
    """(bytes, operations) that one whole-panel LU call must spend: each
    task reads its live front, w^2 values (DL on and below the diagonal, DU
    strictly below), its two live below blocks, 2*nb*w values, and its
    widths and nbelow entries, and writes the four deltas in full,
    2*cp^2 + 2*rbp*cp values; the no-pivot LU takes 2/3 w^3 flops and the
    two below solves nb*w^2 each."""
    w = widths.clamp(0, cp).double()
    nb = nbelow.clamp(0, rbp).double()
    B = widths.shape[0]
    nbytes = (float((w * w + 2.0 * nb * w).sum()) * item
              + 2.0 * B * (cp * cp + rbp * cp) * item + 8.0 * B)
    return nbytes, float((2.0 / 3.0 * w ** 3 + 2.0 * nb * w * w).sum())


def panel_calls(ctx, dev):
    """(widths, nbelow, cp, rbp, blocks) of every PC step of the plan, the
    task-major blocks copied from the assembled (not yet factored) arrays:
    (Draw, Braw) for Cholesky, (DL, DU, BL, BU) for LU."""
    import torch
    from spfx_torch.kernels import blocks
    plan = ctx.plan
    if is_lu(ctx):
        arrays = [blocks.assemble(torch.as_tensor(idx, device=dev), v,
                                  plan.storage)
                  for idx, v in zip((plan.assembly_idx,
                                     plan.assembly_idx_u),
                                    ctx.entry_values(ctx.A))]
    else:
        arrays = [blocks.assemble(torch.as_tensor(plan.assembly_idx,
                                                  device=dev),
                                  ctx.entry_values(ctx.A), plan.storage)]
    out = []
    for lp in plan.levels:
        for pb in lp.panels:
            widths, nbelow, _ = pb.to_u(dev)
            B, cp, rbp = widths.shape[0], pb.cp, pb.rbp
            lo = int(pb.slab_lo[0])
            blks = [x[lo:lo + B * (cp + rbp) * cp].view(B, cp + rbp, cp)
                    for x in arrays]
            out.append((widths, nbelow, cp, rbp,
                        [b[:, :cp].contiguous() for b in blks]
                        + [b[:, cp:].contiguous() for b in blks]))
    return out


def panel_fns(lu: bool):
    """(plain, {family: kernel}) of one kind; the kernels take their own
    layout, the plain version task-major."""
    from spfx_torch.kernels import panel_lanes, panel_wide
    if lu:
        return panel_wide.lu_panel_deltas_plain, {
            "lanes": panel_lanes.lu_panel_deltas_lanes,
            "wide": panel_wide.lu_panel_deltas_wide}
    return panel_wide.chol_panel_deltas_plain, {
        "lanes": panel_lanes.chol_panel_deltas_lanes,
        "wide": panel_wide.chol_panel_deltas_wide}


def run_family(fam: str, fn, w, nb, blks, cp: int, rbp: int):
    """One kernel call on task-major blocks; its outputs task-major."""
    from spfx_torch.kernels.panel_lanes import to_lanes, to_task_major
    if fam == "lanes":
        return tuple(to_task_major(t) for t in
                     fn(w, nb, *(to_lanes(b) for b in blks), cp, rbp))
    return fn(w, nb, *blks, cp, rbp)


def panel_residuals(w, nb, cp: int, rbp: int, blks, outs, lu: bool):
    """[(what, max |residual|, scale)] of the factor that ``outs`` (the
    deltas, task-major) make of ``blks``, in f64 on the live part:
    Cholesky L11 L11^T = D and L21 L11^T = B; LU L11 U11 = D, L21 U11 = BL
    and U12^T L11^T = BU."""
    import torch
    blks = [b.double() for b in blks]
    outs = [o.double() for o in outs]
    i = torch.arange(cp, device=w.device)
    cm = i[None, :] < w[:, None]
    live = (cm[:, :, None] & cm[:, None, :]).double()
    bm = ((torch.arange(rbp, device=w.device)[None, :] < nb[:, None])
          [:, :, None] & cm[:, None, :]).double()
    mx = lambda t: float(t.abs().max()) if t.numel() else 0.0
    if lu:
        DL, DU, BL, BU = blks
        ddl, ddu, dbl, dbu = outs
        D = torch.tril(DL * live) + torch.tril(DU * live, -1).transpose(1, 2)
        L = (DL + ddl) * live
        U = ((DU + ddu) * live).transpose(1, 2)
        L21 = (BL + dbl) * bm
        U12t = (BU + dbu) * bm
        res = [("L11 U11 = D", (L @ U - D) * live, mx(L) * mx(U) * cp)]
        if rbp:
            res += [("L21 U11 = BL", (L21 @ U - BL) * bm,
                     mx(L21) * mx(U) * cp),
                    ("U12^T L11^T = BU", (U12t @ L.transpose(1, 2) - BU) * bm,
                     mx(U12t) * mx(L) * cp)]
    else:
        Draw, Braw = blks
        dd, db = outs
        Dl = torch.tril(Draw * live)
        D = Dl + torch.tril(Dl, -1).transpose(1, 2)
        L = (Draw + dd) * live
        L21 = (Braw + db) * bm
        res = [("L11 L11^T = D", (L @ L.transpose(1, 2) - D) * live,
                mx(L) ** 2 * cp)]
        if rbp:
            res.append(("L21 L11^T = B", (L21 @ L.transpose(1, 2) - Braw)
                        * bm, mx(L21) * mx(L) * cp))
    return [(what, mx(r), max(s, 1.0)) for what, r, s in res]


def panel_edge_calls(dev, gen, lu: bool):
    """Seeded calls of one kind, task-major as ``panel_calls`` gives them, at
    the edges of the whole-panel kernels' 32-column blocks and 32-row tiles
    (the same in both families):
    (cp, rbp, B) = (256, 2561, 1) with w = 255, nb = 2500 (a masked last
    block, rbp one past a multiple of 32); (256, 0, 2) (no below rows);
    (160, 33, 1) (one row in the last tile); (96, 70, 2) with a dead task
    (w = 0, nb = 0) beside a full one; (70, 45, 3), a width that is no
    multiple of 32 (a padded workspace row) and three tasks. Cholesky: SPD
    windows X X^T + cp I with junk above the diagonal; LU: diagonally
    dominant unsymmetric fronts A as DL (lower) and DU (U^T strictly lower),
    with junk where neither side is read; as the CPU tests make them."""
    import torch
    out = []
    for cp, rbp, ws, nbs in ((256, 2561, [255], [2500]),
                             (256, 0, [256, 131], [0, 0]),
                             (160, 33, [160], [33]),
                             (96, 70, [0, 96], [0, 70]),
                             (70, 45, [70, 33, 1], [45, 0, 44])):
        B = len(ws)
        f64 = dict(device=dev, dtype=torch.float64)
        eye = torch.eye(cp, **f64)
        X = torch.randn((B, cp, cp), generator=gen, **f64)
        if lu:
            X = X + (X.abs().sum(2, keepdim=True) + 1.0) * eye
            junk = torch.triu(torch.full((cp, cp), 5.0, **f64), 1)
            blks = [torch.tril(X) + junk,
                    torch.tril(X.mT, -1) + junk + 3.0 * eye]
        else:
            D = X @ X.mT + cp * eye
            blks = [torch.tril(D) + torch.triu(torch.full_like(D, 7.0), 1)]
        blks += [torch.randn((B, rbp, cp), generator=gen, **f64)
                 for _ in range(2 if lu else 1)]
        i32 = dict(device=dev, dtype=torch.int32)
        out.append((torch.tensor(ws, **i32), torch.tensor(nbs, **i32), cp,
                    rbp, blks))
    return out


def check_panels(calls, dtype: str, lu: bool):
    """Every call of both families of one kind against the plain version,
    and the reconstructions of ``panel_residuals``. Tolerances: kernel vs
    plain f32 1e-4, f64 1e-12, relative to the largest entry of the plain
    outputs (the same recurrences, sums taken in other orders, blocked by
    32 columns in the kernels); reconstructions f32 1e-6, f64 1e-14,
    relative to cp times the product of the factors' largest entries (a
    w-term sum's rounding). Returns {kernel name: largest |kernel - plain|}
    for both families."""
    import torch
    td = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 1e-12
    rtol = 1e-6 if dtype == "float32" else 1e-14
    kind = "lu" if lu else "chol"
    plain, fams = panel_fns(lu)
    worst = {f"{kind}_panel_{f}": 0.0 for f in fams}
    for w, nb, cp, rbp, blks in calls:
        blks = [b.to(td) for b in blks]
        ref = plain(w, nb, *blks, cp, rbp)
        scale = max(max((float(r.abs().max()) for r in ref if r.numel()),
                        default=0.0), 1.0)
        for fam, fn in fams.items():
            name = f"{kind}_panel_{fam}"
            outs = run_family(fam, fn, w, nb, blks, cp, rbp)
            err = max(max_diff(o, r) for o, r in zip(outs, ref))
            if not err <= tol * scale:
                fail(f"{name} {dtype} (cp {cp}, rbp {rbp}, B {len(w)}): "
                     f"{err:.3e} from its plain version")
            worst[name] = max(worst[name], err)
            for what, res, s in panel_residuals(w, nb, cp, rbp, blks, outs,
                                                lu):
                if not res <= rtol * s:
                    fail(f"{name} {dtype} (cp {cp}, rbp {rbp}): {what} off "
                         f"by {res:.3e} (scale {s:.3e})")
    torch.cuda.synchronize()
    return worst


def chol_library(w, nb, cp: int, rbp: int, Draw, Braw):
    """The Cholesky library yardstick of one call, ``cholesky_ex`` +
    ``solve_triangular``, as a closure over its masked inputs: the live
    block symmetrized from its lower triangle, the identity on the
    padding, the live below entries."""
    import torch
    i = torch.arange(cp, device=w.device)
    cm = i[None, :] < w[:, None]
    live = cm[:, :, None] & cm[:, None, :]
    bm = (torch.arange(rbp, device=w.device)[None, :] < nb[:, None]
          )[:, :, None] & cm[:, None, :]
    Dl = torch.tril(torch.where(live, Draw, 0))
    Dm = (Dl + torch.tril(Dl, -1).transpose(1, 2)
          + torch.diag_embed((~cm).to(Draw.dtype)))
    Bmm = torch.where(bm, Braw, 0)

    def library():
        Lc, _ = torch.linalg.cholesky_ex(Dm)
        if rbp:
            return torch.linalg.solve_triangular(Lc.mT, Bmm, upper=True,
                                                 left=False)
        return Lc
    return library


def lu_library(w, nb, cp: int, rbp: int, DL, DU, BL, BU):
    """The LU library yardstick of one call, ``lu_factor_ex(pivot=False)``
    + two ``solve_triangular``, as a closure over its masked inputs: the
    live front (DL on and below the diagonal, DU^T above it), the identity
    on the padding, the live below entries."""
    import torch
    i = torch.arange(cp, device=w.device)
    cm = i[None, :] < w[:, None]
    live = cm[:, :, None] & cm[:, None, :]
    bm = (torch.arange(rbp, device=w.device)[None, :] < nb[:, None]
          )[:, :, None] & cm[:, None, :]
    low = i[:, None] >= i[None, :]
    Dm = (torch.where(live & low, DL, 0)
          + torch.where(live & ~low, DU.transpose(1, 2), 0)
          + torch.diag_embed((~cm).to(DL.dtype)))
    BLm, BUm = torch.where(bm, BL, 0), torch.where(bm, BU, 0)

    def library():
        LU, _, _ = torch.linalg.lu_factor_ex(Dm, pivot=False)
        if not rbp:
            return LU
        return (torch.linalg.solve_triangular(LU, BLm, upper=True,
                                              left=False),
                torch.linalg.solve_triangular(
                    LU.mT, BUm, upper=True, left=False, unitriangular=True))
    return library


def device_ms(fn, reps: int = 5) -> float:
    """Device time of one call of ``fn`` under torch.profiler: the sum of
    its CUDA kernels' self times over ``reps`` eager calls, per call (for
    a call that cannot be captured in a CUDA graph, whose eager time counts
    its host launches too)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return cuda_self_ms(prof.key_averages()) / reps


def cuda_self_ms(events) -> float:
    """The sum of the CUDA kernels' self times of a profile's
    ``key_averages()``, in ms, as the profiler table's footer counts it."""
    import torch
    return sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3


def panel_rows(calls, dtype: str, lu: bool):
    """Times (kernel, plain, library) and bound of both families of one kind
    at the path's largest call by work, and of all of the path's calls in
    one graph; the library calls over the path too. LU's library calls
    cannot be captured (``lu_factor_ex(pivot=False)``), so they are timed
    eagerly, their host launches included, and their device time is taken
    from the profiler beside (``library_device_ms``,
    ``library_path_device_ms``)."""
    import torch
    from spfx_torch.kernels.panel_lanes import to_lanes
    td = getattr(torch, dtype)
    item = torch.tensor([], dtype=td).element_size()
    work_of = lu_panel_work if lu else chol_panel_work
    make_library = lu_library if lu else chol_library
    kind = "lu" if lu else "chol"
    plain, fams = panel_fns(lu)
    w, nb, cp, rbp, blks = max(calls, key=lambda c: work_of(
        c[0], c[1], c[2], c[3], item)[1])
    blks = [b.to(td) for b in blks]
    bms, by = bound(*work_of(w, nb, cp, rbp, item), dtype)
    library = make_library(w, nb, cp, rbp, *blks)
    library_ms = time_ms(library, graph=not lu)
    library_device = device_ms(library) if lu else None
    plain_ms = time_ms(lambda: plain(w, nb, *blks, cp, rbp), reps=2,
                       rounds=3)
    rows = {}
    pcd = [(c[0], c[1], c[2], c[3], [b.to(td) for b in c[4]])
           for c in calls]
    work = [work_of(c[0], c[1], c[2], c[3], item) for c in pcd]
    path_bound = bound(sum(b for b, _ in work), sum(o for _, o in work),
                       dtype)[0]
    libs = [make_library(*c[:4], *c[4]) for c in pcd]

    def library_path():
        for lib in libs:
            lib()
    library_path_ms = time_ms(library_path, reps=1, rounds=3, graph=not lu)
    library_path_device = device_ms(library_path, reps=1) if lu else None
    del libs
    for fam, fn in fams.items():
        if fam == "lanes":
            ins = [to_lanes(b) for b in blks]
            pins = [(c[0], c[1], c[2], c[3], [to_lanes(b) for b in c[4]])
                    for c in pcd]
        else:
            ins, pins = blks, pcd

        def path(fn=fn, pins=pins):
            for pw, pn, pc, pr, pb in pins:
                fn(pw, pn, *pb, pc, pr)

        rows[f"{kind}_panel_{fam}"] = dict(
            shape=f"cp={cp} rbp={rbp} B={len(w)}",
            ms=time_ms(lambda fn=fn, ins=ins: fn(w, nb, *ins, cp, rbp)),
            plain_ms=plain_ms, library_ms=library_ms,
            library_device_ms=library_device, bound_ms=bms,
            bound_by=by, path_ms=time_ms(path, reps=1, rounds=3),
            path_bound_ms=path_bound, library_path_ms=library_path_ms,
            library_path_device_ms=library_path_device)
        del pins
    return rows


def check_getrf(calls, dtype: str, local: bool = False):
    """Every getrf_inv call against the plain version, plus the
    reconstructions L U = D, L^{-1} L = I and U U^{-1} = I on the live part
    (padding put back as identity). Tolerance: f32 1e-4, f64 1e-12,
    relative to the largest entry of the outputs; the two sides take the
    same recurrences with sums in other orders (and the card fuses
    multiply-adds). The reconstructions: f32 1e-5, f64 1e-12, relative to
    the product of the factors' largest entries. complex64 and complex128
    (getrf_inv_c) take the tolerances of f32 and f64. With ``local``
    (blocks whose rows or columns differ in scale), each row of L and U and
    each column of L^{-1} and U^{-1} is held against the largest plain
    entry of that row or column, and each entry of the reconstructions
    against the same entry of |L| |U|, |L^{-1}| |L| and |U| |U^{-1}|."""
    import torch
    from spfx_torch.kernels import panel
    td = getattr(torch, dtype)
    single = dtype in ("float32", "complex64")
    tol = 1e-4 if single else 1e-12
    rtol = 1e-5 if single else 1e-12
    hi = torch.complex128 if td.is_complex else torch.float64
    worst = 0.0
    for wrel, D in calls:
        D = D.to(td)
        outs = panel.getrf_inv(wrel, D)
        refs = panel.getrf_inv_plain(wrel, D)
        err = max(max_diff(o, r) for o, r in zip(outs, refs))
        scale = max(max(float(r.abs().max()) for r in refs), 1.0)
        if local:
            ok = all(bool(((o - r).abs() <= tol * r.abs().amax(
                dim, keepdim=True)).all())
                for o, r, dim in zip(outs, refs, (2, 2, 1, 1)))
        else:
            ok = err <= tol * scale
        if not ok:
            fail(f"getrf_inv {dtype}: {err:.3e} from its plain version"
                 + (" (by row of L and U, column of the inverses)"
                    if local else ""))
        worst = max(worst, err)
        L, U, Li, Ui = (o.to(hi) for o in outs)
        Dm, cm = panel.masked_full_block(wrel, D.to(hi))
        live = (cm[:, :, None] & cm[:, None, :]).double()
        pad = torch.diag_embed((~cm).double())
        eye = torch.eye(D.shape[1], dtype=torch.float64, device=D.device)
        mx = lambda t: float(t.abs().max())
        for what, res, a, b in (
                ("L U = D", (L @ U - Dm) * live, L, U),
                ("Linv L = I", Li @ (L + pad) - eye, Li, L + pad),
                ("U Uinv = I", (U + pad) @ Ui - eye, U + pad, Ui)):
            if local:
                ok = bool((res.abs() <= rtol * (a.abs() @ b.abs())).all())
            else:
                ok = mx(res) <= rtol * max(mx(a) * mx(b), 1.0)
            if not ok:
                fail(f"getrf_inv {dtype}: {what} off by {mx(res):.3e}")
    torch.cuda.synchronize()
    return worst


def getrf_rows(L, gcalls, dtype: str):
    """Times (kernel, plain, library) and bound of getrf_inv at the LU
    path's largest call, and over all of its calls in one graph."""
    import torch
    from spfx_torch.kernels import panel
    item = L.element_size()
    wrel, D = max(gcalls, key=lambda c: c[0].shape[0])
    D = D.to(L.dtype)
    B, nb = D.shape[0], D.shape[1]
    bms, by = bound(*getrf_work(wrel, nb, item), dtype)
    Dm, _ = panel.masked_full_block(wrel, D)
    eye = torch.eye(nb, dtype=D.dtype, device=D.device).expand(B, nb, nb)

    def library():
        LU, _, _ = torch.linalg.lu_factor_ex(Dm, pivot=False)
        return (torch.linalg.solve_triangular(LU, eye, upper=False,
                                              unitriangular=True),
                torch.linalg.solve_triangular(LU, eye, upper=True))

    row = dict(
        shape=f"B={B} nb={nb}",
        ms=time_ms(lambda: panel.getrf_inv(wrel, D)),
        plain_ms=time_ms(lambda: panel.getrf_inv_plain(wrel, D), reps=2),
        # lu_factor_ex(pivot=False) cannot be captured in a CUDA graph
        library_ms=time_ms(library, graph=False),
        bound_ms=bms, bound_by=by)
    # per launch on the first 1 and 256 blocks of that call: a launch's
    # time is one block's path, whatever the batch
    for b in (1, 256):
        if B >= b:
            wb, Db = wrel[:b].contiguous(), D[:b].contiguous()
            row[f"ms_b{b}"] = time_ms(lambda: panel.getrf_inv(wb, Db))
    pcd = [(w, d.to(L.dtype)) for w, d in gcalls]

    def getrfs():
        for w, d in pcd:
            panel.getrf_inv(w, d)

    work = [getrf_work(w, d.shape[1], item) for w, d in pcd]
    row["path_ms"] = time_ms(getrfs, reps=1, rounds=3)
    row["path_bound_ms"] = bound(sum(b for b, _ in work),
                                 sum(o for _, o in work), dtype)[0]
    return row


def check_potrf(calls, dtype: str, local: bool = False):
    """Every potrf_inv call against the plain version, plus the
    reconstructions L L^T = D and L^{-1} L = I on the live part.
    Tolerance: f32 1e-4, f64 1e-12, relative to the largest entry; the two
    sides take the same recurrence with sums in other orders. complex64
    and complex128 (potrf_inv_c: L L^H = D, D Hermitian from its lower
    triangle) take the tolerances of f32 and f64. With ``local`` (blocks
    whose rows differ in scale by orders of magnitude), the same
    tolerances hold each row of L and each column of L^{-1} against the
    largest plain entry of that row or column, and each entry of the
    reconstructions against the same entry of |L| |L|^T and
    |L^{-1}| |L|."""
    import torch
    from spfx_torch.kernels import panel
    td = getattr(torch, dtype)
    single = dtype in ("float32", "complex64")
    tol = 1e-4 if single else 1e-12
    rtol = 1e-5 if single else 1e-12
    hi = torch.complex128 if td.is_complex else torch.float64
    worst = 0.0
    for wrel, D in calls:
        D = D.to(td)
        L, Li = panel.potrf_inv(wrel, D)
        Lp, Lip = panel.potrf_inv_plain(wrel, D)
        dl, di = (L - Lp).abs(), (Li - Lip).abs()
        err = max(float(dl.max()), float(di.max()))
        scale = max(float(Lp.abs().max()), float(Lip.abs().max()), 1.0)
        if local:
            ok = bool((dl <= tol * Lp.abs().amax(2, keepdim=True)).all()
                      and (di <= tol * Lip.abs().amax(1, keepdim=True)).all())
        else:
            ok = err <= tol * scale
        if not ok:
            fail(f"potrf_inv {dtype}: {err:.3e} from its plain version"
                 + (" (by row of L, column of L^-1)" if local else ""))
        worst = max(worst, err)
        Dm, cm = panel.masked_block(wrel, D)
        Dm = (Dm + Dm.tril(-1).mH).to(hi)
        live = (cm[:, :, None] & cm[:, None, :]).double()
        pad = torch.diag_embed((~cm).double())
        Ld, Lid = L.to(hi), Li.to(hi)
        rec = (Ld @ Ld.mH - Dm) * live
        inv = Lid @ (Ld + pad) - torch.eye(
            D.shape[1], dtype=torch.float64, device=D.device)
        if local:
            ok = bool((rec.abs() <= rtol * (Ld.abs() @ Ld.abs().transpose(
                1, 2))).all() and (inv.abs() <= rtol * (
                    Lid.abs() @ (Ld + pad).abs())).all())
        else:
            ok = (float(rec.abs().max()) <= rtol * float(Dm.abs().max())
                  and float(inv.abs().max()) <= rtol * scale)
        if not ok:
            fail(f"potrf_inv {dtype}: reconstruction off")
    torch.cuda.synchronize()
    return worst


def kernel_rows(L, gcalls, pcalls, dtype: str):
    """Times (kernel, plain, library) and bounds at the main path's
    largest call of each kernel."""
    import torch
    from spfx_torch.kernels import gather, panel
    rows = {}
    item = L.element_size()
    sa, wa, sb, wb = max(gcalls, key=lambda c: gather_bytes(c, item))
    idx_a = (torch.div(sa.clamp(min=0).long(), 1024, rounding_mode="floor")
             * 1024)[:, None] + torch.arange(wa, device=L.device)
    idx_b = (torch.div(sb.clamp(min=0).long(), 1024, rounding_mode="floor")
             * 1024)[:, None] + torch.arange(wb, device=L.device)
    nbytes = gather_bytes((sa, wa, sb, wb), item)
    bms, by = bound(nbytes, 0.0, dtype)
    rows["window_gather2"] = dict(
        shape=f"Ba={sa.shape[0]} win_a={wa} Bb={sb.shape[0]} win_b={wb}",
        ms=time_ms(lambda: gather.window_gather2(L, sa, wa, sb, wb)),
        plain_ms=time_ms(lambda: gather.window_gather2_plain(L, sa, wa, sb,
                                                             wb)),
        library_ms=time_ms(lambda: (L[idx_a], L[idx_b])),
        bound_ms=bms, bound_by=by)
    nb1 = gather_bytes((sa, wa, sa[:0], wb), item)
    bms, by = bound(nb1, 0.0, dtype)
    rows["window_gather"] = dict(
        shape=f"B={sa.shape[0]} win={wa}",
        ms=time_ms(lambda: gather.window_gather(L, sa, wa)),
        plain_ms=time_ms(lambda: gather.window_gather_plain(L, sa, wa)),
        library_ms=time_ms(lambda: L[idx_a]),
        bound_ms=bms, bound_by=by)
    wrel, D = max(pcalls, key=lambda c: c[0].shape[0])
    D = D.to(L.dtype)
    B, nb = D.shape[0], D.shape[1]
    bms, by = bound(*potrf_work(wrel, nb, item), dtype)
    Dm, _ = panel.masked_block(wrel, D)
    eye = torch.eye(nb, dtype=D.dtype, device=D.device).expand(B, nb, nb)

    def library():
        Lc, _ = torch.linalg.cholesky_ex(Dm)
        return torch.linalg.solve_triangular(Lc, eye, upper=False)

    rows["potrf_inv"] = dict(
        shape=f"B={B} nb={nb}",
        ms=time_ms(lambda: panel.potrf_inv(wrel, D)),
        plain_ms=time_ms(lambda: panel.potrf_inv_plain(wrel, D), reps=2),
        library_ms=time_ms(library),
        bound_ms=bms, bound_by=by)
    return rows


def path_kernel_ms(L, gcalls, pcalls, dtype: str):
    """Device time and bound of all of the path's calls of each kernel:
    every call of one factorization, captured in one graph and replayed."""
    from spfx_torch.kernels import gather, panel
    item = L.element_size()

    def gathers():
        for c in gcalls:
            gather.window_gather2(L, *c)

    pcd = [(w, D.to(L.dtype)) for w, D in pcalls]

    def potrfs():
        for w, D in pcd:
            panel.potrf_inv(w, D)

    gb = sum(gather_bytes(c, item) for c in gcalls)
    work = [potrf_work(w, D.shape[1], item) for w, D in pcd]
    pbytes = sum(b for b, _ in work)
    pops = sum(o for _, o in work)
    return {"window_gather2": (time_ms(gathers, reps=1, rounds=3),
                               bound(gb, 0.0, dtype)[0]),
            "potrf_inv": (time_ms(potrfs, reps=1, rounds=3),
                          bound(pbytes, pops, dtype)[0])}


# --------------------------------------------------------------------------
# phase 3d: extend_add_rows at every UT step
# --------------------------------------------------------------------------

def extend_call(slabs, rows, es) -> None:
    """extend_add_rows on one slab, extend_add_rows2 on two."""
    from spfx_torch.kernels import extend_add
    if len(slabs) == 1:
        extend_add.extend_add_rows(slabs[0], rows, es[0])
    else:
        extend_add.extend_add_rows2(slabs[0], slabs[1], rows, es[0], es[1])


def check_extend_add(L, calls, dtype: str, gen, U=None, edges: bool = True):
    """Every call of extend_add_rows (given ``U``, a second flat array of
    L's size: of extend_add_rows2 on the step's slab views of L and U)
    against the plain version on each slab, E seeded in the step's shape,
    the kernel in place on the step's slab views. Tolerance: f32 1e-6, f64
    1e-14 of the slab's largest entry (repeated rows summed in another
    order: atomics on the card); complex64 and complex128 (the real views
    of their rows) those of f32 and f64. Then, with ``edges``, the
    adversarial calls of ``check_extend_edges`` at the largest step's
    shape. Returns the largest |kernel - plain|."""
    import torch
    from spfx_torch.kernels import extend_add
    arrays = [L] if U is None else [L, U]
    what = "extend_add_rows" if U is None else "extend_add_rows2"
    tol = 1e-6 if dtype in ("float32", "complex64") else 1e-14
    worst = 0.0
    for lo, srows, csp, rows in calls:
        ss = [x[lo:lo + srows * csp].view(srows, csp) for x in arrays]
        es = [torch.randn((rows.shape[0], csp), generator=gen,
                          device=L.device, dtype=L.dtype) for _ in arrays]
        refs = [extend_add.extend_add_rows_plain(s.clone(), rows, e)
                for s, e in zip(ss, es)]
        extend_call(ss, rows, es)
        for got, ref in zip(ss, refs):
            err = max_diff(got, ref)
            if not err <= tol * float(ref.abs().max()):
                fail(f"{what} {dtype} (srows {srows}, csp {csp}, "
                     f"{rows.shape[0]} rows): {err:.3e} from the plain "
                     "version")
            worst = max(worst, err)
    if not edges:
        torch.cuda.synchronize()
        return worst
    lo, srows, csp, rows = max(calls, key=lambda c: c[3].shape[0] * c[2])
    check_extend_edges([x[lo:lo + srows * csp].view(srows, csp)
                        for x in arrays], rows, dtype, gen)
    torch.cuda.synchronize()
    return worst


def check_extend_edges(slabs, rows, dtype: str, gen):
    """Adversarial calls of extend_add_rows on one slab (of
    extend_add_rows2 on two of the same shape) at one step's shape,
    integer values throughout, so that any order of the atomics gives the
    plain version's bits: every row on one slab row; every row dropped
    (the slabs untouched); and, on seeded tables with repeated and dropped
    rows, two calls that take the kernel's single-value path, csp = 33 and
    a slab that starts one value past a 16-byte boundary."""
    import torch
    from spfx_torch.kernels import extend_add
    slab = slabs[0]
    what = "extend_add_rows" if len(slabs) == 1 else "extend_add_rows2"

    def same(ss, r, es, label):
        refs = [extend_add.extend_add_rows_plain(s.clone(), r, e)
                for s, e in zip(ss, es)]
        extend_call(ss, r, es)
        if not all(torch.equal(s, ref) for s, ref in zip(ss, refs)):
            fail(f"{what} {dtype}: {label} differ from the plain version")

    dev = slab.device
    ss = [torch.round(4 * s) for s in slabs]
    es = [torch.round(4 * torch.randn((rows.shape[0], slab.shape[1]),
                                      generator=gen, device=dev,
                                      dtype=slab.dtype)) for _ in slabs]
    same(ss, torch.full_like(rows, slab.shape[0] // 2), es,
         f"{rows.shape[0]} rows on one slab row")
    before = [s.clone() for s in ss]
    extend_call(ss, torch.full_like(rows, -1), es)
    if not all(torch.equal(s, b) for s, b in zip(ss, before)):
        fail(f"{what} {dtype}: dropped rows changed the slab")
    Rs, RE = 100, 1000
    r = torch.randint(-20, Rs, (RE,), generator=gen, device=dev,
                      dtype=torch.int32)
    for csp, off in ((33, 0), (32, 1)):
        flats = [torch.round(4 * torch.randn(Rs * csp + off, generator=gen,
                                             device=dev, dtype=slab.dtype))
                 for _ in slabs]
        ss = [f[off:].view(Rs, csp) for f in flats]
        es = [torch.round(4 * torch.randn((RE, csp), generator=gen,
                                          device=dev, dtype=slab.dtype))
              for _ in slabs]
        ptrs = [t.data_ptr() for t in ss + es]
        if extend_add.vector_path(csp, slab.element_size(), ptrs):
            fail(f"{what} {dtype}: csp {csp}, offset {off} takes the "
                 "16-byte path")
        same(ss, r, es, f"csp {csp}, offset {off} (single values)")


def rotating(fn, inputs):
    """A call of ``fn`` that takes the next input set of ``inputs`` each
    time, round robin: captured in a graph, the rotation is recorded, so
    no set is met again until the others have passed through the cache."""
    it = itertools.cycle(inputs)
    return lambda: fn(*next(it))


def extend_add_rows_row(L, calls, dtype: str, gen, lu):
    """Times (kernel, plain, library: the masked index_add_ it replaces)
    and bound at the path's largest call by bytes, and of all of the path's
    calls in one graph (their E views of one seeded buffer); the same for
    the LU path's extend_add_rows2 calls, ``lu`` = (Lx, Ux, calls), each
    bounded by twice one call's bytes less one read of the row table
    (``lu_path_ms``, ``lu_path_bound_ms``). The largest
    call's slab and E fit in the 50 MB L2 cache, so its calls rotate over
    copies of them (slab, E and the library's masked E) that together
    exceed twice the L2: each call meets its inputs in device memory, as
    the byte bound assumes."""
    import torch
    from spfx_torch.bench.kernel_probe import extend_add_bytes
    from spfx_torch.kernels import extend_add
    item = L.element_size()
    lo, srows, csp, rows = max(calls, key=lambda c: extend_add_bytes(
        c[3], c[2], item))
    live = rows >= 0
    idx = torch.where(live, rows, 0).long()
    copies = min(16, 1 + int(2 * L2_BYTES
                             // ((srows + 2 * rows.shape[0]) * csp * item)))
    sets = []
    for _ in range(copies):
        E = torch.randn((rows.shape[0], csp), generator=gen, device=L.device,
                        dtype=L.dtype)
        sets.append((L[lo:lo + srows * csp].view(srows, csp).clone(), E,
                     torch.where(live[:, None], E, 0)))
    bms, by = bound(extend_add_bytes(rows, csp, item), 0.0, dtype)
    row = dict(
        shape=f"srows={srows} csp={csp} RE={rows.shape[0]} live="
              f"{int(live.sum())} "
              f"targets={torch.unique(rows[live]).numel()}",
        ms=time_ms(rotating(lambda s, e, _: extend_add.extend_add_rows(
            s, rows, e), sets)),
        plain_ms=time_ms(rotating(
            lambda s, e, _: extend_add.extend_add_rows_plain(s, rows, e),
            sets)),
        library_ms=time_ms(rotating(
            lambda s, _, em: s.index_add_(0, idx, em, alpha=-1), sets)),
        bound_ms=bms, bound_by=by)
    del sets
    buf = torch.randn(max(c[3].shape[0] * c[2] for c in calls),
                      generator=gen, device=L.device, dtype=L.dtype)
    pins = [(L[lo:lo + sr * cs].view(sr, cs), r,
             buf[:r.shape[0] * cs].view(-1, cs))
            for lo, sr, cs, r in calls]

    def path():
        for s, r, e in pins:
            extend_add.extend_add_rows(s, r, e)

    row["path_ms"] = time_ms(path, reps=1, rounds=3)
    row["path_bound_ms"] = bound(sum(extend_add_bytes(r, cs, item)
                                     for _, _, cs, r in calls), 0.0,
                                 dtype)[0]
    Lx, Ux, lcalls = lu
    bufs = [torch.randn(max(c[3].shape[0] * c[2] for c in lcalls),
                        generator=gen, device=L.device, dtype=L.dtype)
            for _ in range(2)]
    lpins = [(Lx[lo:lo + sr * cs].view(sr, cs),
              Ux[lo:lo + sr * cs].view(sr, cs), r,
              *(b[:r.shape[0] * cs].view(-1, cs) for b in bufs))
             for lo, sr, cs, r in lcalls]

    def lu_path():
        for sl, su, r, el, eu in lpins:
            extend_add.extend_add_rows2(sl, su, r, el, eu)

    row["lu_path_ms"] = time_ms(lu_path, reps=1, rounds=3)
    # each slab's live rows of E and distinct targets, the table once
    row["lu_path_bound_ms"] = bound(sum(2 * extend_add_bytes(r, cs, item)
                                        - 4 * r.shape[0]
                                        for _, _, cs, r in lcalls), 0.0,
                                    dtype)[0]
    return row


# --------------------------------------------------------------------------
# phase 3e: cholesky_small_batched
# --------------------------------------------------------------------------

CHOL_SMALL_SHAPES = ([(64, 8), (64, 1), (64, 7), (64, 16), (SMALL_BATCH, 32)]
                     + [(b, c) for c in range(1, 33) for b in (1, 3, 133)])
CHOL_SMALL_OFFSET = [(133, 32), (133, 16), (3, 2)]   # D one value past
                                                     # 16-byte alignment


def small_spd(batch: int, c: int, dev, gen):
    """(D with junk above the diagonal, the SPD matrix of its lower
    triangle), f64: X X^T + c I. The junk is 1e3, NaN in matrices 0, 4,
    8, ... and +Inf in matrices 2, 6, ...: half of them."""
    import torch
    X = torch.randn(batch, c, c, generator=gen, device=dev,
                    dtype=torch.float64)
    D = X @ X.transpose(1, 2) + c * torch.eye(c, device=dev,
                                              dtype=torch.float64)
    Dj = D + torch.triu(torch.full_like(D, 1e3), 1)
    up = torch.ones(c, c, dtype=torch.bool, device=dev).triu(1)
    Dj[0::4] = Dj[0::4].masked_fill(up, float("nan"))
    Dj[2::4] = Dj[2::4].masked_fill(up, float("inf"))
    return Dj, D


def check_chol_small(dev, gen):
    """Every shape of CHOL_SMALL_SHAPES (c from 1 to 32 at batches 1, 3
    and 133, a few more, and (65,536, 32)), f32 and f64, with the junk of
    ``small_spd`` above the diagonal: against the plain version (f32 1e-4,
    f64 1e-12 of the largest entry: the same recurrence, sums in other
    orders and fused on the card), L L^T = D (f32 1e-5, f64 1e-12 of D's
    largest entry), exact zeros above the diagonal, and bit for bit the
    kernel's factor of the same input with zeros above the diagonal; the
    CHOL_SMALL_OFFSET shapes with D one value past 16-byte alignment (the
    single-value path where the 16-byte one would serve) bit for bit the
    aligned input's factor. Returns {dtype: largest |kernel - plain|}."""
    import torch
    from spfx_torch.kernels import chol_small
    worst = {}
    for batch, c in CHOL_SMALL_SHAPES:
        Dj, D = small_spd(batch, c, dev, gen)
        for dtype in ("float32", "float64"):
            td = getattr(torch, dtype)
            what = f"cholesky_small_batched {dtype} ({batch}, {c})"
            L = chol_small.cholesky_small_batched(Dj.to(td))
            ref = chol_small.cholesky_small_batched_plain(Dj.to(td))
            err = max_diff(L, ref)
            tol, rtol = (1e-4, 1e-5) if dtype == "float32" else (1e-12, 1e-12)
            if not err <= tol * max(float(ref.abs().max()), 1.0):
                fail(f"{what}: {err:.3e} from its plain version")
            Ld = L.double()
            rec = float((Ld @ Ld.transpose(1, 2) - D).abs().max())
            if not rec <= rtol * float(D.abs().max()):
                fail(f"{what}: L L^T = D off by {rec:.3e}")
            if not bool((torch.triu(L, 1) == 0).all()):
                fail(f"{what}: nonzero above the diagonal")
            clean = chol_small.cholesky_small_batched(torch.tril(D).to(td))
            if not torch.equal(L, clean):
                fail(f"{what}: the junk above the diagonal changed L")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    for batch, c in CHOL_SMALL_OFFSET:
        _, D = small_spd(batch, c, dev, gen)
        for dtype in ("float32", "float64"):
            td = getattr(torch, dtype)
            buf = torch.empty(batch * c * c + 1, dtype=td, device=dev)
            Do = buf[1:].view(batch, c, c)
            Do.copy_(D)
            if not torch.equal(chol_small.cholesky_small_batched(Do),
                               chol_small.cholesky_small_batched(D.to(td))):
                fail(f"cholesky_small_batched {dtype} ({batch}, {c}): "
                     "unaligned D gives another L")
    torch.cuda.synchronize()
    return worst


def check_chol_small_pivot(dev, gen):
    """A negative pivot (d_77 = -1e3 in matrix 2 of 5) at c = 32 and 13,
    f32 and f64: NaN in the same places as the plain version (from (7, 7)
    on, in that matrix only), the other entries within the tolerances of
    ``check_chol_small``."""
    import torch
    from spfx_torch.kernels import chol_small
    for c in (32, 13):
        Dj, _ = small_spd(5, c, dev, gen)
        Dj[2, 7, 7] = -1e3
        for dtype in ("float32", "float64"):
            td = getattr(torch, dtype)
            what = f"cholesky_small_batched {dtype} (5, {c}), negative pivot"
            L = chol_small.cholesky_small_batched(Dj.to(td))
            ref = chol_small.cholesky_small_batched_plain(Dj.to(td))
            nan = torch.isnan(ref)
            if not (torch.equal(torch.isnan(L), nan) and bool(nan[2, 7, 7])
                    and int(nan.sum()) == (c - 7) * (c - 6) // 2):
                fail(f"{what}: NaN in {int(torch.isnan(L).sum())} places, "
                     f"the plain version in {int(nan.sum())}")
            tol = 1e-4 if dtype == "float32" else 1e-12
            err = max_diff(L[~nan], ref[~nan])
            if not err <= tol * max(float(ref[~nan].abs().max()), 1.0):
                fail(f"{what}: {err:.3e} from its plain version")
    torch.cuda.synchronize()


def chol_small_row(dev, gen):
    """Times (kernel, plain, library: cholesky_ex of the symmetric matrix)
    and bound at (65,536, 32) f32: each matrix's lower triangle read,
    c(c+1)/2 values, its factor written, c^2, for c^3/3 flops; beside
    them the same four numbers in f64 at (65,536, 32) and in f32 at
    (65,536, 16)."""
    import torch
    from spfx_torch.kernels import chol_small

    def inputs(batch, c, td):
        _, D = small_spd(batch, c, dev, gen)
        return (D + torch.triu(torch.full_like(D, 1e3), 1)).to(td), D.to(td)

    def bound_of(batch, c, dtype):
        return bound(batch * (c * (c + 1) / 2 + c * c)
                     * (4.0 if dtype == "float32" else 8.0),
                     batch * c ** 3 / 3.0, dtype)

    batch, c = SMALL_BATCH, 32
    Dj, D = inputs(batch, c, torch.float32)
    bms, by = bound_of(batch, c, "float32")
    row = dict(
        shape=f"batch={batch} c={c}",
        ms=time_ms(lambda: chol_small.cholesky_small_batched(Dj)),
        plain_ms=time_ms(lambda: chol_small.cholesky_small_batched_plain(Dj),
                         reps=2, rounds=3),
        library_ms=time_ms(lambda: torch.linalg.cholesky_ex(D)),
        bound_ms=bms, bound_by=by)
    for key, c, dtype in (("f64", 32, "float64"), ("c16", 16, "float32")):
        Dj, D = inputs(batch, c, getattr(torch, dtype))
        row[f"ms_{key}"] = time_ms(
            lambda: chol_small.cholesky_small_batched(Dj))
        row[f"plain_ms_{key}"] = time_ms(
            lambda: chol_small.cholesky_small_batched_plain(Dj), reps=2,
            rounds=3)
        row[f"library_ms_{key}"] = time_ms(
            lambda: torch.linalg.cholesky_ex(D))
        row[f"bound_ms_{key}"] = bound_of(batch, c, dtype)[0]
    return row


# --------------------------------------------------------------------------
# phase 3f: potrf_inv_c and getrf_inv_c
# --------------------------------------------------------------------------

def edge_diag_c_calls(dev, lu: bool):
    """Seeded complex128 calls at nb = 32 (a generator of their own, so
    that the other checks' draws stay as they were): blocks of widths 0, 1,
    7, 8, 9, 31 and 32 in one call, and one block scaled by 2^40, one by
    2^70 and one by 2^-70 (where the square of a complex64 pivot's modulus
    leaves float32's range, so that a division forming it would fail).
    Cholesky: X X^H + 32 I with 1e3 (1 + i) above the diagonal; LU:
    diagonally dominant blocks with both triangles filled."""
    import torch
    own = torch.Generator(device=dev)
    own.manual_seed(40 + lu)
    c128 = dict(device=dev, dtype=torch.complex128)
    X = torch.randn(8, 32, 32, generator=own, **c128)
    if lu:
        D = X + torch.diag_embed(X.abs().sum(2) + 1.0)
    else:
        D = X @ X.mH + 32 * torch.eye(32, **c128)
        D = D + torch.triu(torch.full((32, 32), 1e3 + 1e3j, **c128), 1)
    w = torch.tensor([0, 1, 7, 8, 9, 31, 32], device=dev, dtype=torch.int32)
    return [(w, D[:7].contiguous())] + [
        (w[-1:].contiguous(), (D[7:] * 2.0 ** e).contiguous())
        for e in (40, 70, -70)]


def diag_c_rows(pcalls, lcalls):
    """Times (kernel, plain, library) and bounds of potrf_inv_c and
    getrf_inv_c at the complex64 48^3 plans' largest calls (by batch), and
    over all of each path's calls in one graph; each kernel also at B = 1
    on its plan's widest block (the first of full width: a launch's floor
    is its widest block's path), and in complex128 at the same calls. The
    library calls are cholesky_ex + solve_triangular and
    lu_factor_ex(pivot=False) + two solve_triangular, timed eagerly (their
    complex batched paths are not captured). Bounds: the bytes of
    potrf_work / getrf_work at 8 bytes a value (16 in complex128) over the
    memory rate, or 4x their real operations (a complex multiply-add is
    four real ones) over the f32 (f64) peak."""
    import torch
    from spfx_torch.bench.kernel_probe import widest_block
    from spfx_torch.kernels import panel
    rows = {}
    for name, calls, fn, plain, work, masked in (
            ("potrf_inv_c", pcalls, panel.potrf_inv, panel.potrf_inv_plain,
             potrf_work, panel.masked_block),
            ("getrf_inv_c", lcalls, panel.getrf_inv, panel.getrf_inv_plain,
             getrf_work, panel.masked_full_block)):
        wrel, D = max(calls, key=lambda c: c[0].shape[0])
        B, nb = D.shape[0], D.shape[1]
        nbytes, ops = work(wrel, nb, D.element_size())
        bms, by = bound(nbytes, 4 * ops, "float32")
        Dm, _ = masked(wrel, D)
        eye = torch.eye(nb, dtype=D.dtype, device=D.device).expand(B, nb, nb)
        if name == "potrf_inv_c":
            def library():
                Lc, _ = torch.linalg.cholesky_ex(Dm)
                return torch.linalg.solve_triangular(Lc, eye, upper=False)
        else:
            def library():
                LU, _, _ = torch.linalg.lu_factor_ex(Dm, pivot=False)
                return (torch.linalg.solve_triangular(
                            LU, eye, upper=False, unitriangular=True),
                        torch.linalg.solve_triangular(LU, eye, upper=True))

        def path(calls=calls):
            for w, d in calls:
                fn(w, d)

        pw = [work(w, d.shape[1], d.element_size()) for w, d in calls]
        w1, D1 = widest_block(calls)
        bytes128, ops128 = work(wrel, nb, 16)
        c128 = [(w, d.to(torch.complex128)) for w, d in calls]
        D128, D1_128 = D.to(torch.complex128), D1.to(torch.complex128)
        rows[name] = dict(
            shape=f"B={B} nb={nb} complex64",
            ms=time_ms(lambda: fn(wrel, D)),
            plain_ms=time_ms(lambda: plain(wrel, D), reps=2),
            library_ms=time_ms(library, graph=False),
            bound_ms=bms, bound_by=by,
            path_ms=time_ms(path, reps=1, rounds=3),
            path_bound_ms=bound(sum(b for b, _ in pw),
                                4 * sum(o for _, o in pw), "float32")[0],
            b1_width=int(w1[0].clamp(0, nb)),
            ms_b1=time_ms(lambda: fn(w1, D1)),
            ms_c128=time_ms(lambda: fn(wrel, D128)),
            ms_b1_c128=time_ms(lambda: fn(w1, D1_128)),
            path_ms_c128=time_ms(lambda: path(c128), reps=1, rounds=3),
            bound_ms_c128=bound(bytes128, 4 * ops128, "float64")[0])
        del c128
    return rows


# --------------------------------------------------------------------------
# phase 3g: bmm_bf16x3 at the UT products
# --------------------------------------------------------------------------

BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core rate, data sheet


def _transposed(G):
    return G.transpose(1, 2).contiguous().transpose(1, 2)


def _unaligned(G):
    import torch
    flat = torch.empty(G.numel() + 1, device=G.device)
    out = flat[1:].view(G.shape)
    out.copy_(G)
    return out


# (batch, m, k, n, A's view): calls whose A bmm_bf16x3 copies into its
# kernel's layout first, a transposed A (the panel path's kind) and an A
# one value off its allocation
COPIED_BF16X3 = [(17, 96, 32, 70, _transposed), (9, 64, 64, 36, _unaligned)]


def check_bf16x3(shapes, gen, dev):
    """bmm_bf16x3 at every UT product shape (each read as it lies), and
    at COPIED_BF16X3's calls (each copied first), against
    bmm_bf16x3_plain: both
    split alike and multiply bf16 values exactly, so they differ only in
    the order of the float32 sums of 3k terms: each entry within
    3 k 2^-22 of its sum |a||b| (the two orders' rounding, 2^-23 a term
    each with a margin for the tensor cores' accumulation). The plain
    version against the float64 product: within (3 x 2^-16 + k 2^-22) of
    sum |a||b| (the bf16x3 error model: the split's and the dropped lo.lo
    term's 2^-16 each, and three float32 sums of k terms at 2^-24 a term),
    and its largest error below one
    bf16 pass's on the same inputs. Returns the largest |kernel - plain|
    and the largest plain and single-pass errors relative to sum |a||b|."""
    import torch
    from spfx_torch.bench.kernel_probe import bmm_operands
    from spfx_torch.kernels import matmul
    worst = rel3 = rel1 = 0.0
    for shape in shapes + COPIED_BF16X3:
        G, Ht = bmm_operands(shape[:4], gen, dev)
        want = "fast"
        if len(shape) > 4:
            G, want = shape[4](G), "copy"
        if matmul.path(G, Ht) != want:
            fail(f"bmm_bf16x3 at {shape[:4]}: path {matmul.path(G, Ht)!r}, "
                 f"not {want!r}")
        k = shape[2]
        got = matmul.bmm_bf16x3(G, Ht)
        ref = matmul.bmm_bf16x3_plain(G, Ht)
        S = torch.bmm(G.abs().double(), Ht.abs().double())
        d = (got - ref).abs().double()
        if not bool((d <= 3 * k * 2.0 ** -22 * S).all()):
            fail(f"bmm_bf16x3 at {shape[:4]}: {float(d.max()):.3e} from its "
                 "plain version")
        worst = max(worst, float(d.max()))
        exact = torch.bmm(G.double(), Ht.double())
        e3 = (ref.double() - exact).abs()
        if not bool((e3 <= (3 * 2.0 ** -16 + k * 2.0 ** -22) * S).all()):
            fail(f"bmm_bf16x3_plain at {shape[:4]}: outside the bf16x3 "
                 "model")
        one = torch.bmm(G.bfloat16().double(), Ht.bfloat16().double())
        e1 = (one - exact).abs()
        if not float(e3.max()) < float(e1.max()):
            fail(f"bmm_bf16x3_plain at {shape[:4]}: {float(e3.max()):.3e} not "
                 f"below one bf16 pass's {float(e1.max()):.3e}")
        Sm = S.clamp(min=1e-300)
        rel3 = max(rel3, float((e3 / Sm).max()))
        rel1 = max(rel1, float((e1 / Sm).max()))
    torch.cuda.synchronize()
    return worst, rel3, rel1


def bmm_bf16x3_row(shapes, gen, dev):
    """Times of bmm_bf16x3, its plain version and torch.bmm at full float32
    (the library call) and at TF32, at the largest UT product by
    operations; the bound is the larger of 3 x 2 m n k batch operations
    over the bf16 tensor-core peak and the operands and product's bytes
    over the memory rate; and all of the path's products in one graph,
    by the kernel and by full-float32 torch.bmm."""
    import torch
    from spfx_torch.bench.kernel_probe import bmm_operands
    from spfx_torch.kernels import matmul, mega
    shape = max(shapes, key=lambda s: s[0] * s[1] * s[2] * s[3])
    batch, m, k, n = shape
    G, Ht = bmm_operands(shape, gen, dev)

    def tf32():
        with mega.matmul_precision("default"):
            return torch.bmm(G, Ht)

    ops = 3 * 2.0 * batch * m * n * k
    nbytes = 4.0 * batch * (m * k + k * n + m * n)
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_PEAK * 1e3
    ops_all = sum(3 * 2.0 * b * mm * nn * kk for b, mm, kk, nn in shapes)
    bytes_all = sum(4.0 * b * (mm * kk + kk * nn + mm * nn)
                    for b, mm, kk, nn in shapes)
    pins = [bmm_operands(s, gen, dev) for s in shapes]

    def path():
        for g, h in pins:
            matmul.bmm_bf16x3(g, h)

    def library_path():
        for g, h in pins:
            torch.bmm(g, h)

    row = dict(
        shape=f"batch={batch} m={m} k={k} n={n}",
        ms=time_ms(lambda: matmul.bmm_bf16x3(G, Ht)),
        plain_ms=time_ms(lambda: matmul.bmm_bf16x3_plain(G, Ht)),
        library_ms=time_ms(lambda: torch.bmm(G, Ht)),
        library_tf32_ms=time_ms(tf32),
        bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations",
        path_ms=time_ms(path, reps=1, rounds=3),
        library_path_ms=time_ms(library_path, reps=1, rounds=3),
        path_bound_ms=max(bytes_all / HBM_BYTES_PER_S,
                          ops_all / BF16_PEAK) * 1e3)
    del pins
    return row


# --------------------------------------------------------------------------
# phase 6d: the panel bench
# --------------------------------------------------------------------------

SYRK_SHAPES = [(3, 64, 64, 32), (133, 64, 64, 32), (5, 70, 33, 40),
               (7, 1, 1, 1), (4, 128, 200, 17)]  # (batch, n, m, k)


def check_syrk_gemm(dev, gen):
    """syrk_gemm_batched against its plain version at seeded shapes that
    reach both of its paths (bulk: the bench's item shape, at a batch
    under and one over the persistent grid's 1-in-3 remainder; general:
    n > 64, n = m = k = 1, n + m > 128 with an odd k), in f32 and f64.
    Tolerance 1e-5 (f32) and 1e-13 (f64) of each output's largest entry:
    k-term dot products summed in other orders. Returns ({dtype: largest
    |kernel - plain|}, {path: calls})."""
    import torch
    from spfx_torch.kernels.mega import matmul_precision
    from spfx_torch.kernels import syrk_gemm
    worst, paths = {}, {}
    with matmul_precision("highest"):
        for dtype, tol in (("float32", 1e-5), ("float64", 1e-13)):
            td = getattr(torch, dtype)
            worst[dtype] = 0.0
            for batch, n, m, k in SYRK_SHAPES:
                A = torch.randn(batch, n, k, generator=gen, device=dev,
                                dtype=td)
                B = torch.randn(batch, m, k, generator=gen, device=dev,
                                dtype=td)
                p = syrk_gemm.path(n, m, k, A.element_size(), A.data_ptr(),
                                   B.data_ptr())
                paths[p] = paths.get(p, 0) + 1
                for got, ref in zip(syrk_gemm.syrk_gemm_batched(A, B),
                                    syrk_gemm.syrk_gemm_batched_plain(A, B)):
                    e = max_diff(got, ref)
                    if not e <= tol * float(ref.abs().max()):
                        fail(f"syrk_gemm_batched {dtype} {p} path at "
                             f"{(batch, n, m, k)}: {e:.3e} from its plain "
                             "version")
                    worst[dtype] = max(worst[dtype], e)
    if sorted(paths) != ["bulk", "general"]:
        fail(f"syrk_gemm_batched checks reached the paths {paths}")
    torch.cuda.synchronize()
    return worst, paths


def panel_bench(dev):
    """spfx_torch.bench.panels.main() at its full size, its launches
    (one warm and REPS timed calls of syrk_gemm_batched, nothing else),
    the custom kernel's S and G against the einsum strategy (1e-5 of each
    output's largest entry, f32: 32-term dot products summed in other
    orders), and syrk_gemm_batched's times (kernel, plain, library: a
    torch.bmm pair) and bound at that size. Returns (GFLOP/s by strategy,
    launches, timing row, largest |kernel - einsum|)."""
    import torch
    from spfx_torch.bench import panels
    from spfx_torch.kernels.mega import matmul_precision
    from spfx_torch.kernels import _cuda, syrk_gemm
    _cuda.reset_launch_counts()
    gflops = panels.main()
    launches = _cuda.launch_counts()
    want = dict.fromkeys(launches, 0)
    want["syrk_gemm_batched"] = 1 + panels.REPS
    if launches != want:
        fail(f"panel bench: launches {launches}, expected {want}")
    log("[panels] GFLOP/s " + json.dumps(gflops))
    A, B = panels.inputs(device=dev)
    batch, n, k = A.shape
    m = B.shape[1]
    with matmul_precision("highest"):
        err = 0.0
        for got, ref in zip(panels.strategy_custom(A, B),
                            panels.strategy_batched(A, B)):
            e = max_diff(got, ref)
            if not e <= 1e-5 * float(ref.abs().max()):
                fail(f"panel bench: the custom kernel is {e:.3e} from the "
                     "einsum strategy")
            err = max(err, e)
        At = A.transpose(1, 2)
        bms, by = bound(4.0 * batch * (n * k + m * k + n * n + m * n),
                        2.0 * batch * (n * n * k + m * n * k), "float32")
        row = dict(
            shape=f"batch={batch} n={n} m={m} k={k}",
            ms=time_ms(lambda: syrk_gemm.syrk_gemm_batched(A, B), reps=3,
                       rounds=3),
            plain_ms=time_ms(lambda: syrk_gemm.syrk_gemm_batched_plain(A, B),
                             reps=3, rounds=3),
            library_ms=time_ms(lambda: (torch.bmm(A, At), torch.bmm(B, At)),
                               reps=3, rounds=3),
            bound_ms=bms, bound_by=by)
    torch.cuda.synchronize()
    return gflops, launches, row, err


# --------------------------------------------------------------------------
# phases 4-6: the main path
# --------------------------------------------------------------------------

def is_lu(ctx) -> bool:
    """Whether a context (in-core or streaming) factors LU."""
    import spfx_torch
    return isinstance(ctx, spfx_torch.LU) \
        or getattr(ctx, "lu", False) is True


def panel_shape(pb) -> tuple:
    """(cp, rbp) of a PC or rowwin P bucket."""
    if hasattr(pb, "cp"):
        return pb.cp, pb.rbp
    return pb.diag_row_start.shape[1], pb.below_row_start.shape[1]


def predicted_launches(ctx) -> dict:
    """Launches of one factorization under the SPFX_PANEL_KERNEL mode set
    now, by bucket kind: a UT step one window_gather2 per factor array and
    one extend_add_rows (LU's twin takes both arrays); a UC step one
    extend_add_rows; a rowwin U step none; with update_precision "high" in
    float32, every update step one bmm_bf16x3 (LU: two, the crossed
    products); a PC or rowwin P step either one launch of its route's
    whole-panel kernel or, on the blocked route (a complex plan's only
    route), one diagonal-block kernel per 32 columns (getrf_inv for LU,
    potrf_inv for Cholesky; getrf_inv_c and potrf_inv_c when complex). A
    config with matmul_precision "high" is not predicted."""
    from spfx_torch.kernels import _cuda, route
    from spfx_torch.plan.schedule import UpdateBucketC
    plan = ctx.plan
    cfg = ctx.config
    lu = is_lu(ctx)
    mode = route.panel_mode()
    cplx = "complex" in cfg.dtype
    item = {"float32": 4, "float64": 8, "complex64": 8,
            "complex128": 16}[cfg.dtype]
    if cfg.matmul_precision == "high":
        fail("predicted_launches: matmul_precision 'high' is not predicted")
    high = cfg.dtype == "float32" and cfg.update_precision == "high"
    diag = ("getrf_inv" if lu else "potrf_inv") + ("_c" if cplx else "")
    want = dict.fromkeys(_cuda.launch_counts(), 0)
    for lp in plan.levels:
        for ub in lp.updates:
            if high:
                want["bmm_bf16x3"] += 2 if lu else 1
            if isinstance(ub, UpdateBucketC):
                want["extend_add_rows"] += 1
                if ub.head_start is not None:
                    want["window_gather2"] += 2 if lu else 1
        for pb in lp.panels:
            cp, rbp = panel_shape(pb)
            r = route.route_panel(cp, rbp, len(pb.widths), item, lu,
                                  mode=mode, cplx=cplx)
            if r == "blocked":
                want[diag] += -(-cp // 32)
            else:
                want[f"{'lu' if lu else 'chol'}_panel_{r}"] += 1
    return want


@contextlib.contextmanager
def panel_env(mode):
    """Run a block with SPFX_PANEL_KERNEL set to ``mode`` (None: unset),
    restoring the variable afterwards."""
    old = os.environ.pop("SPFX_PANEL_KERNEL", None)
    if mode is not None:
        os.environ["SPFX_PANEL_KERNEL"] = mode
    try:
        yield
    finally:
        os.environ.pop("SPFX_PANEL_KERNEL", None)
        if old is not None:
            os.environ["SPFX_PANEL_KERNEL"] = old


def plan_summary(ctx) -> dict:
    """The plan's sizes: what one factorization launches and moves."""
    from spfx_torch.plan.schedule import UpdateBucketC
    plan = ctx.plan
    ups = [ub for lp in plan.levels for ub in lp.updates]
    ut = [ub for ub in ups if isinstance(ub, UpdateBucketC)
          and ub.head_start is not None]
    pc = [pb for lp in plan.levels for pb in lp.panels]
    arrays = 2 if is_lu(ctx) else 1
    return dict(n=plan.n, nnzL=int(ctx.sym.nnzL), flops=plan.flops,
                levels=len(plan.levels), ut_steps=len(ut),
                update_steps=len(ups), pc_steps=len(pc),
                factor_arrays=arrays,
                gather_windows=2 * arrays * sum(len(ub.kw) for ub in ut),
                diag_block_calls=sum(-(-panel_shape(pb)[0] // 32)
                                     for pb in pc),
                diag_blocks=sum(len(pb.widths) * -(-panel_shape(pb)[0] // 32)
                                for pb in pc),
                storage=plan.storage)


def factor_arrays(f):
    return (f.Lx, f.Ux) if hasattr(f, "Ux") else (f.L,)


def main_path(ctx, A, label: str, repeats: int = 5,
              unrefined_limit: float | None = None,
              extras: tuple = ()):
    """Factorize through the context's runner: on a panel mode's first
    factorization the runner warms up and captures its graph, so the
    capture's launch counts are held against the plan (every kernel of the
    path launched, as often as the plan says) and the run's own counts,
    warm-up and capture, against twice that. Then ``repeats`` steady
    factorizations, each one replay with the counters unmoved (median
    wall); ``entry_values``' host time; the graph factor against the eager
    walk's (``trace_fn``, what engine="calls" runs) on the same entry
    values, within 1e-5 (f32) or 1e-12 (f64) of each array's largest
    entry; the refined solve (and, given ``unrefined_limit``, the residual
    without refinement against it). ``extras``: "graph" adds
    ``graph_report``, "solve" ``device_solve_report``, "replay"
    ``replay_event_ms``. Returns (factor, launches, the capture's
    launches, report)."""
    import torch
    from spfx_torch import scaled_residual, synth_rhs
    from spfx_torch.kernels import _cuda, route
    mode = route.panel_mode()
    fresh = ctx._runner is None or mode not in ctx._runner.captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    _cuda.reset_launch_counts()
    f = ctx.factorize(A)
    launches = _cuda.launch_counts()
    first = ctx.factorize_time
    held = torch.cuda.memory_allocated() - mem0
    runner = ctx._runner
    cap = runner.captures[mode]
    want = predicted_launches(ctx)
    if cap["launches"] != want:
        fail(f"{label}: the capture launched {cap['launches']}, the plan "
             f"predicts {want}")
    twice = {k: 2 * v if fresh else 0 for k, v in want.items()}
    if launches != twice:
        fail(f"{label}: the first factorization launched {launches}; its "
             f"warm-up and capture should launch {twice}")
    if fresh and not all(launches[k] > 0 for k, v in want.items() if v):
        fail(f"{label}: a kernel of the path was not launched: {launches}")
    ts = []
    for _ in range(repeats):
        replays = runner.replays
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = ctx.factorize(A)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
        moved = {k: v for k, v in _cuda.launch_counts().items() if v}
        if runner.replays != replays + 1 or moved:
            fail(f"{label}: a steady factorization was "
                 f"{runner.replays - replays} replays and launched {moved}")
    med = statistics.median(ts)
    peak = torch.cuda.max_memory_allocated()
    if not all(bool(torch.isfinite(t).all()) for t in factor_arrays(f)):
        fail(f"{label}: factor has non-finite values")
    t0 = time.perf_counter()
    vals = ctx.entry_values(A)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    vals = vals if is_lu(ctx) else (vals,)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = runner.trace_fn()(*vals)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager = eager if is_lu(ctx) else (eager,)
    tol = 1e-5 if ctx.config.dtype in ("float32", "complex64") else 1e-12
    graph_err = {}
    for name, g, e in zip(("Lx", "Ux") if is_lu(ctx) else ("L",),
                          factor_arrays(f), eager):
        scale = float(e.abs().max())
        graph_err[name] = max_diff(g, e) / scale
        if not graph_err[name] <= tol:
            fail(f"{label}: the graph's {name} is {graph_err[name]:.3e} of "
                 f"its largest entry from the eager walk's (limit {tol:g})")
    del eager, vals
    b = synth_rhs(A, cplx="complex" in ctx.config.dtype)
    t0 = time.perf_counter()
    x0 = f.solve(b, refine=0)
    x = f.solve(b)
    solve_s = time.perf_counter() - t0
    r0 = scaled_residual(A, x0, b)
    res = scaled_residual(A, x, b)
    rep = dict(plan_summary(ctx), analyze_s=ctx.analyze_time, plan_s=ctx.plan_time,
               first_factorize_s=first, warmup_s=cap["warmup_s"],
               capture_s=cap["capture_s"],
               first_replay_s=cap["first_replay_s"], factorize_s=med,
               factorize_all_s=ts, entry_values_s=entry_s,
               eager_walk_s=eager_s, graph_vs_eager=graph_err,
               gflops=ctx.plan.flops / med / 1e9, peak_mem_gb=peak / 1e9,
               peak_rise_gb=(peak - mem0) / 1e9, held_mem_gb=held / 1e9,
               reserved_mem_gb=torch.cuda.memory_reserved() / 1e9,
               solve_s=solve_s, residual_norefine=r0, residual=res,
               launches=launches, graph_launches=cap["launches"])
    if "replay" in extras:
        rep["replay_event_ms"] = replay_event_ms(runner, mode)
    if "graph" in extras:
        rep.update(graph_report(ctx, A, f, med, mode, label))
    if "solve" in extras:
        rep.update(device_solve_report(ctx, A, f, label))
    log(f"[{label}] " + json.dumps(rep))
    if not res <= 1e-12:
        fail(f"{label}: scaled residual {res:.3e} > 1e-12")
    if unrefined_limit is not None and not r0 <= unrefined_limit:
        fail(f"{label}: scaled residual without refinement {r0:.3e} > "
             f"{unrefined_limit:g}")
    return f, launches, cap["launches"], rep


def replay_event_ms(runner, mode: str) -> float:
    """One replay of the runner's graph for ``mode`` (the fused engine: its
    chunks' graphs in order) between CUDA events, median of 5."""
    import torch
    g = runner._graphs[mode]
    replay = g.graph.replay if hasattr(g, "graph") else g.replay
    ev = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        replay()
        b.record()
        b.synchronize()
        ev.append(a.elapsed_time(b))
    return statistics.median(ev)


def stamps_phase(ctx, A, label: str) -> dict:
    """Phase 4j for one context whose default graph was captured with the
    recorder on: the step stamps of a replay against CUDA events around
    it (each of 3 replays; the sum within 3% of the median), the factor
    against the factor of a runner whose graph was captured with the
    recorder off (within the graph-against-eager limit, beside two
    replays' distance), both graphs' replays between CUDA events (median
    of 5 each, in turns), and the solve graph's capture times kept by the
    context's MegaSolver (phase 4's device solve report captured one)."""
    import torch
    from spfx_torch.kernels import route
    from spfx_torch.kernels.mega import MegaRunner
    from spfx_torch.utils import instrument
    runner, mode = ctx._runner, route.panel_mode()
    g = runner._graphs[mode]
    if g.stamps is None:
        fail(f"{label}: the default graph has no step stamps")
    vals = ctx.entry_values(A)
    vals = vals if is_lu(ctx) else (vals,)

    def arrays(out):
        return out if is_lu(ctx) else (out,)
    stamped = [arrays(runner.run(*vals)) for _ in range(2)]
    instrument.enable(False)
    try:
        plain = MegaRunner(ctx.plan, lu=is_lu(ctx), config=ctx.config,
                           device=ctx.device)
        got = arrays(plain.run(*vals))
    finally:
        instrument.enable(True)
    if plain._graphs[mode].stamps is not None:
        fail(f"{label}: a graph captured with the recorder off has stamps")
    # the walk's atomics (scatter_add_, the extend-add) order its sums
    # differently from one replay to the next, so the two graphs' factors
    # are held to the graph-against-eager limit, beside the distance
    # between two replays of one graph
    tol = 1e-5 if ctx.config.dtype in ("float32", "complex64") else 1e-12
    floor, dist = {}, {}
    for name, a, a2, b in zip(("Lx", "Ux") if is_lu(ctx) else ("L",),
                              *stamped, got):
        scale = float(b.abs().max())
        floor[name] = max_diff(a, a2) / scale
        dist[name] = max_diff(a, b) / scale
        if not dist[name] <= tol:
            fail(f"{label}: the stamped graph's {name} is {dist[name]:.3e} "
                 f"of its largest entry from the unstamped graph's (limit "
                 f"{tol:g})")
    sums, ev = [], {"stamped": [], "plain": []}
    for i in range(5):
        for key, gr in (("stamped", g), ("plain", plain._graphs[mode])):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            gr.graph.replay()
            b.record()
            b.synchronize()
            ev[key].append(a.elapsed_time(b))
            if key == "stamped" and i < 3:
                st = g.stamps.resolve()
                sums.append((st["assembly_ms"] + st["ut_ms"] + st["pc_ms"],
                             ev[key][-1], st))
    ratio = statistics.median(s / e for s, e, _ in sums)
    st = sums[-1][2]
    # phase 4's device solve report captured a solve graph for one
    # right-hand side on the context's solver
    solve_cap = ctx._solver.captures.get(1)
    if not solve_cap or not (solve_cap["warmup_s"] > 0
                             and solve_cap["capture_s"] > 0):
        fail(f"{label}: MegaSolver kept no capture times: {solve_cap}")
    rep = dict(stamps_over_events=ratio, solve_capture=solve_cap,
               stamped_vs_unstamped=dist, replay_vs_replay=floor,
               stamps_ms=[s for s, _, _ in sums],
               events_ms=[e for _, e, _ in sums],
               assembly_ms=st["assembly_ms"], ut_ms=st["ut_ms"],
               pc_ms=st["pc_ms"], levels=len(st["levels"]),
               stamped_replay_ms=statistics.median(ev["stamped"]),
               plain_replay_ms=statistics.median(ev["plain"]))
    log(f"[{label} stamps] " + json.dumps(rep))
    if not 0.97 <= ratio <= 1.03:
        fail(f"{label}: the step stamps sum to {ratio:.4f} of the CUDA "
             "events around the replay (limit 3%)")
    del plain, got, stamped
    torch.cuda.empty_cache()
    return rep


def profiled_ms(fn):
    """(device ms, kernel names) of one call of ``fn`` under
    torch.profiler (CUDA activity only): the sum of its kernels' self
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return cuda_self_ms(events), [
        e.key for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA]


def graph_report(ctx, A, f, steady_s: float, mode: str, label: str) -> dict:
    """One replay's profiled device time against one eager walk's on the
    same entry values (the profiler must attribute the graph's kernels:
    the window gathers of a UT plan, else the diagonal-block kernel, and
    the two device times agree within 10%), the device-busy share of a
    steady factorization (replay device time over its median wall), the
    replay alone between CUDA events, the first factor bit for bit
    unchanged by a factorization of 2A on the same context, and
    run_repeat's slope between 1 and 4 replays."""
    import torch
    runner = ctx._runner
    g = runner._graphs[mode]
    replay_ms, names = profiled_ms(g.graph.replay)
    eager_ms, _ = profiled_ms(lambda: runner.trace_fn()(*g.inputs))
    # a kernel every step of the path's plan launches: the window gathers
    # of a UT plan, else the blocked route's diagonal-block kernel
    marker = ("window_gather" if predicted_launches(ctx)["window_gather2"]
              else "getrf_inv" if is_lu(ctx) else "potrf_inv")
    if not any(marker in n for n in names):
        fail(f"{label}: the profiler shows no {marker} kernel in a "
             f"replay: {names[:10]}")
    if not 0.9 <= replay_ms / eager_ms <= 1.1:
        fail(f"{label}: a replay's device time {replay_ms:.3f} ms is not "
             f"within 10% of the eager walk's {eager_ms:.3f} ms")
    ev = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.graph.replay()
        b.record()
        b.synchronize()
        ev.append(a.elapsed_time(b))
    keep = [t.clone() for t in factor_arrays(f)]
    f2 = ctx.factorize(2 * A)
    if not all(torch.equal(t, k) for t, k in zip(factor_arrays(f), keep)):
        fail(f"{label}: factorizing 2A changed the first factor")
    if torch.equal(factor_arrays(f2)[0], keep[0]):
        fail(f"{label}: the factor of 2A is the factor of A")
    del f2, keep
    vals = ctx.entry_values(A)
    vals = vals if is_lu(ctx) else (vals,)

    def wall(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run_repeat(reps, *vals)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    w1 = statistics.median(wall(1) for _ in range(3))
    w4 = statistics.median(wall(4) for _ in range(3))
    return dict(replay_device_ms=replay_ms, eager_device_ms=eager_ms,
                replay_over_eager_device=replay_ms / eager_ms,
                replay_kernel_names=len(names),
                device_busy_share=replay_ms / 1e3 / steady_s,
                replay_event_ms=statistics.median(ev),
                run_repeat_1_s=w1, run_repeat_4_s=w4,
                run_repeat_slope_s=(w4 - w1) / 3)


def device_solve_report(ctx, A, f, label: str) -> dict:
    """The same factor with Config(solve_backend="device"): its unrefined
    solve (the first call captures the solve graph, a second replays it)
    beside the host solve's, the largest difference between the two
    unrefined solutions relative to the host's largest entry, and the
    refined residual (<= 1e-12)."""
    import dataclasses
    import numpy as np
    from spfx_torch import (CholeskyFactor, LUFactor, scaled_residual,
                            synth_rhs)
    cfg = dataclasses.replace(f.config, solve_backend="device")
    if is_lu(ctx):
        fd = LUFactor(f.A, f.sym, f.plan, f.Lx, f.Ux, cfg,
                      solver=ctx._solver, row_perm=f.row_perm)
    else:
        fd = CholeskyFactor(f.A, f.sym, f.plan, f.L, cfg,
                            solver=ctx._solver)
    b = synth_rhs(A, cplx="complex" in f.config.dtype)
    times = {}
    for key, fn in (("device_solve_first_s", fd), ("device_solve_s", fd),
                    ("host_solve_s", f)):
        t0 = time.perf_counter()
        x = fn.solve(b, refine=0)
        times[key] = time.perf_counter() - t0
        if fn is fd:
            xd = x
    xh = f.solve(b, refine=0)
    res = scaled_residual(A, fd.solve(b), b)
    rep = dict(times, device_residual_norefine=scaled_residual(A, xd, b),
               device_residual=res,
               device_vs_host_norefine=float(np.abs(xd - xh).max()
                                             / np.abs(xh).max()))
    if not res <= 1e-12:
        fail(f"{label}: device solve's refined residual {res:.3e} > 1e-12")
    return rep


def profile_pass(ctx, A, name: str) -> float:
    """One factorization under torch.profiler; the kernel table goes to
    chiprun_out/<name>.txt. Returns the device time in ms: the sum of the
    CUDA kernels' self times, as the table's footer counts it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ctx.factorize(A)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ctx.factorize(A)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_ms = cuda_self_ms(events)
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(ROOT, "chiprun_out", f"{name}.txt"), "w") as fh:
        fh.write(table)
    log(f"[profile] {name}: device time {device_ms:.3f} ms (kernel table "
        f"in chiprun_out/{name}.txt)")
    return device_ms


def surfaces(dev) -> None:
    """The CLI (``spfx_torch.__main__.main``) on laplacian_3d(GRID_CPU)
    and its unsymmetric variant written as MatrixMarket files under
    chiprun_out/surfaces, f32, both kinds, each factor saved
    (--save-factor): rc 0 and one residual line each; both factors loaded
    back onto the card (``spfx_torch.checkpoint.load_factor``), their
    refined solves' residuals <= 1e-12 on the host and on the device
    solve; and one factorization under Config(profile=True) with
    SPFX_PROFILE_DIR set, which must write one Chrome trace."""
    import contextlib
    import dataclasses
    import glob
    import io
    import shutil
    import spfx_torch
    import spfx_torch.__main__ as cli
    from spfx_torch import checkpoint, scaled_residual, synth_rhs
    from spfx_torch.bench.kernel_probe import unsym_laplacian
    from spfx_torch.io import generate, matrix_market
    d = os.path.join(ROOT, "chiprun_out", "surfaces")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    mats = {"spd.mtx": generate.laplacian_3d(GRID_CPU),
            "unsym.mtx": unsym_laplacian(GRID_CPU)}
    for name, M in mats.items():
        matrix_market.write_matrix(os.path.join(d, name), M,
                                   symmetric=name == "spd.mtx")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([os.path.join(d, n) for n in mats]
                      + ["--dtype", "float32", "--save-factor", d])
    text = out.getvalue()
    log("[surfaces] " + " | ".join(text.strip().splitlines()))
    if rc != 0 or text.count("residual") != 2 or "engine=lu" not in text:
        fail(f"CLI: rc {rc}, output {text!r}")
    for name, M in mats.items():
        f = checkpoint.load_factor(os.path.join(d, name + ".factor.npz"))
        arrays = (f.Lx, f.Ux) if hasattr(f, "Ux") else (f.L,)
        if any(t.device.type != "cuda" for t in arrays):
            fail(f"load_factor placed {name}'s factor off the card")
        b = synth_rhs(M)
        fd = dataclasses.replace(f.config, solve_backend="device")
        for cfg in (f.config, fd):
            f.config = cfg
            res = scaled_residual(M, f.solve(b), b)
            if not res <= 1e-12:
                fail(f"loaded {name} ({cfg.solve_backend} solve): "
                     f"residual {res:.3e}")
    old = os.environ.get("SPFX_PROFILE_DIR")
    os.environ["SPFX_PROFILE_DIR"] = d
    try:
        spfx_torch.cholesky(mats["spd.mtx"], spfx_torch.Config(profile=True),
                            device=dev)
    finally:
        os.environ.pop("SPFX_PROFILE_DIR")
        if old is not None:
            os.environ["SPFX_PROFILE_DIR"] = old
    traces = glob.glob(os.path.join(d, "factorize", "*.json"))
    if len(traces) != 1:
        fail(f"profile scope wrote {len(traces)} traces")


def surfaces_complex(dev) -> None:
    """The CLI on complex MatrixMarket files at GRID_CPU^3 under
    chiprun_out/surfaces_c: the magnetic Laplacian (Hermitian, written as
    one triangle, which the reader mirrors conjugated) through the
    Cholesky engine and its unsymmetric variant through auto (LU), both in
    complex64 with complex right-hand sides, each factor saved: rc 0 and
    one residual line each; then both complex checkpoints loaded onto the
    card and solved against a complex right-hand side, refined residual
    <= 1e-12."""
    import contextlib
    import io
    import shutil
    import spfx_torch.__main__ as cli
    from spfx_torch import checkpoint, scaled_residual, synth_rhs
    from spfx_torch.bench.kernel_probe import magnetic_laplacian
    from spfx_torch.io import matrix_market
    d = os.path.join(ROOT, "chiprun_out", "surfaces_c")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    mats = {"herm.mtx": (magnetic_laplacian(GRID_CPU), ["--engine", "chol"]),
            "cunsym.mtx": (magnetic_laplacian(GRID_CPU, unsym=True), [])}
    text = ""
    for name, (M, extra) in mats.items():
        matrix_market.write_matrix(os.path.join(d, name), M,
                                   symmetric=name == "herm.mtx")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main([os.path.join(d, name), "--dtype", "complex64",
                           "--save-factor", d] + extra)
        text += out.getvalue()
        if rc != 0:
            fail(f"CLI on {name}: rc {rc}, output {out.getvalue()!r}")
    log("[surfaces] complex " + " | ".join(text.strip().splitlines()))
    if text.count("residual") != 2 or "engine=chol dtype=complex64" not in \
            text or "engine=lu dtype=complex64" not in text:
        fail(f"CLI on complex files: output {text!r}")
    for name, (M, _) in mats.items():
        f = checkpoint.load_factor(os.path.join(d, name + ".factor.npz"))
        arrays = (f.Lx, f.Ux) if hasattr(f, "Ux") else (f.L,)
        if any(t.device.type != "cuda" or not t.is_complex()
               for t in arrays):
            fail(f"load_factor placed {name}'s factor off the card or "
                 "not complex")
        b = synth_rhs(M, cplx=True)
        res = scaled_residual(M, f.solve(b), b)
        if not res <= 1e-12:
            fail(f"loaded complex {name}: residual {res:.3e}")


# --------------------------------------------------------------------------
# phase 4g: the stage-streamed engines; 4h: the recommender; 6i: both,
# card against CPU
# --------------------------------------------------------------------------

STREAM_STAGE_ELEMS = 1 << 24       # phase 4g's stage cap (values)
STREAM_STAGE_ELEMS_CPU = 1 << 15   # phase 6i's, at 12^3
# phase 4h: the "20m" shape (als_bench) with the users cut to a fifth
ALS_SHAPE = dict(num_users=27600, num_items=27000, avg_degree=144, rank=16,
                 seed=0)
ALS_ITERS = 4                      # the slope's extra iterations
ALS_FULL_ITERS = 3                 # the uncut-caps model's iterations


def streaming_phase(A, sym, defaults: dict, incore_peak: dict, dev,
                    repeats: int = 3) -> dict:
    """4g. StreamingCholesky and StreamingLU at 48^3 f32 with the default
    Config and a cap of STREAM_STAGE_ELEMS values a stage: the stage count;
    the first factorization (every stage's walk warmed up and captured)
    launching each kernel of the path twice as often as the plan predicts,
    the captures once; ``repeats`` steady factorizations, each one replay a
    stage with the counters unmoved; their walls with the upload, walk and
    download times (CUDA events) and the host's packing beside them; the
    peak device memory above the start, which must be below the in-core
    path's (phase 4 / 4b); the factor within 1e-5 of the in-core graph
    factor's largest entry (``defaults``); the refined residual <= 1e-12.
    Returns {path: launches of the first factorization}."""
    import torch
    from spfx_torch import Config, scaled_residual, synth_rhs
    from spfx_torch.kernels import _cuda
    from spfx_torch.stream import StreamingCholesky, StreamingLU
    paths = {}
    for lu, kind in ((False, "cholesky"), (True, "lu")):
        label = f"stream {kind} {GRID}^3 float32"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        _cuda.reset_launch_counts()
        st = (StreamingLU if lu else StreamingCholesky)(
            A, Config(), stage_elems=STREAM_STAGE_ELEMS, sym=sym, device=dev)
        f = st.factorize(A)
        launches = _cuda.launch_counts()
        first, first_stats = st.factorize_time, dict(st.stats)
        cap = st.captures["blocked"]
        want = predicted_launches(st)
        if cap["launches"] != want:
            fail(f"{label}: the captures launched {cap['launches']}, the "
                 f"plan predicts {want}")
        if launches != {k: 2 * v for k, v in want.items()} \
                or not all(launches[k] > 0 for k, v in want.items() if v):
            fail(f"{label}: the first factorization launched {launches}; "
                 f"its warm-ups and captures should launch twice {want}")
        ts, stats = [], []
        for _ in range(repeats):
            _cuda.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f = st.factorize(A)
            ts.append(time.perf_counter() - t0)
            stats.append(dict(st.stats))
            moved = {k: v for k, v in _cuda.launch_counts().items() if v}
            if moved:
                fail(f"{label}: a steady factorization launched {moved}")
        peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
        if not peak < incore_peak[kind]:
            fail(f"{label}: peak device memory {peak:.3f} GB is not below "
                 f"the in-core path's {incore_peak[kind]:.3f} GB")
        dist = {}
        for name, h, d in zip(("Lx", "Ux") if lu else ("L",),
                              factor_arrays(f), defaults[kind][0]):
            hd = h.to(dev)
            dist[name] = max_diff(hd, d) / float(d.abs().max())
            del hd
            if not (dist[name] <= 1e-5 and bool(torch.isfinite(h).all())):
                fail(f"{label}: {name} is {dist[name]:.3e} of its largest "
                     "entry from the in-core graph factor's (limit 1e-5)")
        b = synth_rhs(A)
        res = scaled_residual(A, f.solve(b), b)
        med = statistics.median(ts)
        rep = dict(stages=len(st.stages), stage_elems=STREAM_STAGE_ELEMS,
                   largest_stage=max(s.storage for s in st.stages),
                   storage=st.plan.storage, analyze_s=st.analyze_time,
                   plan_s=st.plan_time, first_factorize_s=first,
                   first_stats=first_stats,
                   warmup_s=cap["warmup_s"], capture_s=cap["capture_s"],
                   factorize_s=med, factorize_all_s=ts,
                   steady_stats=stats[ts.index(med)] if med in ts
                   else stats[-1], peak_rise_gb=peak,
                   incore_peak_rise_gb=incore_peak[kind],
                   incore_factorize_s=defaults[kind][1],
                   vs_incore=dist, residual=res, launches=launches)
        log(f"[{label}] " + json.dumps(rep))
        if not res <= 1e-12:
            fail(f"{label}: scaled residual {res:.3e} > 1e-12")
        paths[f"{kind}_stream"] = launches
        del st, f
        torch.cuda.empty_cache()
    return paths


def popularity_recall(train, test, k: int = 20) -> float:
    """recall@k of recommending each test user the globally most popular
    items it has not seen (tests/test_als.py's baseline, vectorised)."""
    import numpy as np
    ni = train.num_items
    pop = np.bincount(train.item_ids, minlength=ni)
    order = np.argsort(-pop)
    users = np.unique(test.user_ids).astype(np.int64)
    deg = np.bincount(train.user_ids, minlength=train.num_users)
    cand = order[:k + int(deg[users].max())]
    keys = users[:, None] * ni + cand[None, :]
    seen = np.unique(train.user_ids.astype(np.int64) * ni + train.item_ids)
    unseen = ~np.isin(keys, seen)
    top = unseen & (np.cumsum(unseen, axis=1) <= k)
    rel = np.unique(test.user_ids.astype(np.int64) * ni + test.item_ids)
    hits = (np.isin(keys, rel) & top).sum(axis=1)
    nrel = np.bincount(test.user_ids, minlength=test.num_users)[users]
    return float(np.mean(hits / np.minimum(nrel, k)))


def generate_als_data(shape: dict):
    """``synthetic(**shape)`` and the seconds it took (phase 4h's data, made
    in a spawned worker while the card runs the phases before 4h: it takes
    tens of seconds of one host core)."""
    from spfx_torch.recsys import data as rdata
    t0 = time.perf_counter()
    inter = rdata.synthetic(**shape)
    return inter, time.perf_counter() - t0


def recommender_phase(dev, als_data) -> dict:
    """4h. The ALS/iALS recommender at als_bench's full width (rank 64,
    caps 256 / 512, 512-row chunks, f32, "highest") on ALS_SHAPE: the
    generation time; the slope per iteration between fit_steps(1) and
    fit_steps(1 + ALS_ITERS) (one captured iteration replayed) and
    examples/s; U and V finite with their padding rows zero;
    full_implicit_loss below the seeded tables'; recall@20 and NDCG@10
    beside the popularity baseline; the peak device memory; one
    iteration's profiled device time over its wall (the busy share).
    Returns the report and phase 4i's reference: (train, U, V, the slope
    per iteration), the tables whole after the slope's iterations.

    The bench's item cap of 512 drops the interactions of the most
    popular items past their 512th (their rows are cut), and implicit ALS
    reads a dropped positive as a negative, so at this shape the bench
    config's recall@20 sits at the popularity baseline (ROADMAP Queue 3).
    The check that recall@20 beats that baseline therefore runs on a
    second model, the bench config with caps that hold every interaction
    (``full_caps``), after ALS_FULL_ITERS iterations; the bench config's
    recall is reported beside it with the interactions its caps drop.
    ``als_data``: the future of ``generate_als_data(ALS_SHAPE)``."""
    import dataclasses
    import numpy as np
    import torch
    from spfx_torch.bench.als_bench import BENCH_CONFIG, slope
    from spfx_torch.dist.mesh import round_up
    from spfx_torch.recsys.als import ALSModel
    t0 = time.perf_counter()
    inter, gen_s = als_data.result()
    wait_s = time.perf_counter() - t0
    train, test = inter.split(holdout=5, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    m = ALSModel(train, BENCH_CONFIG, device=dev)
    setup_s = time.perf_counter() - t0
    loss0 = m.full_implicit_loss()
    per_iter, t = slope(m, ALS_ITERS)
    # phase 4i's reference: the tables after the slope's iterations
    ref = (train, *(x.clone() for x in m.full_tables()), per_iter)
    peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    U, V = m.U, m.V
    if not (bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all())):
        fail("recommender: non-finite values in U or V")
    if U[train.num_users:].any() or V[train.num_items:].any():
        fail("recommender: a padding row of U or V is not zero")
    loss1 = m.full_implicit_loss()
    if not loss1 < loss0:
        fail(f"recommender: full_implicit_loss {loss1:.6e} is not below the "
             f"seeded tables' {loss0:.6e}")
    t0 = time.perf_counter()
    metrics = m.evaluate(test)
    eval_s = time.perf_counter() - t0
    pop = popularity_recall(train, test)
    ideg = np.bincount(train.item_ids, minlength=train.num_items)
    udeg = np.bincount(train.user_ids, minlength=train.num_users)
    cap = BENCH_CONFIG.item_cap
    dropped = dict(items_over_cap=int((ideg > cap).sum()),
                   interactions_dropped=int(np.maximum(ideg - cap, 0).sum()),
                   max_item_degree=int(ideg.max()),
                   max_user_degree=int(udeg.max()))
    # one iteration (fit_steps(1): copy-in, one replay, clone-out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.fit_steps(1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, _ = profiled_ms(lambda: m.fit_steps(1))
    padded, capture = [m.nu, m.ni], m._fit_steps.capture
    del m, U, V
    torch.cuda.empty_cache()
    # the same model with caps that hold every interaction
    full = dataclasses.replace(
        BENCH_CONFIG, user_cap=round_up(int(udeg.max()), 256),
        item_cap=round_up(int(ideg.max()), 512))
    t0 = time.perf_counter()
    mf = ALSModel(train, full, device=dev)
    mf.fit_steps(ALS_FULL_ITERS)
    full_metrics = mf.evaluate(test)
    full_caps = dict(user_cap=full.user_cap, item_cap=full.item_cap,
                     iters=ALS_FULL_ITERS, seconds=time.perf_counter() - t0,
                     **full_metrics)
    del mf
    torch.cuda.empty_cache()
    if not full_metrics["recall@20"] > pop:
        fail(f"recommender: with every interaction, recall@20 "
             f"{full_metrics['recall@20']:.4f} is not above the popularity "
             f"baseline's {pop:.4f}")
    rep = dict(users=inter.num_users, items=inter.num_items,
               interactions=inter.nnz, train_nnz=train.nnz,
               padded_rows=padded, generate_s=gen_s,
               generate_wait_s=wait_s, model_s=setup_s,
               capture=capture, fit_steps_s=t,
               per_iter_s=per_iter,
               examples_per_sec=train.nnz * 2 / per_iter,
               full_implicit_loss_seeded=loss0, full_implicit_loss=loss1,
               popularity_recall20=pop, evaluate_s=eval_s, **metrics,
               bench_caps_drop=dropped, full_caps=full_caps,
               peak_rise_gb=peak, iteration_wall_ms=wall_ms,
               iteration_device_ms=dev_ms, busy=dev_ms / wall_ms)
    log("[recommender] " + json.dumps(rep))
    return rep, ref


def card_vs_cpu_recsys_stream(dev) -> None:
    """6i. The recommender on the "100k" shape at rank 64 (als_bench's
    config), fit_steps(2) on the card and on the CPU: float64 within 1e-10
    and matmul_precision="high" in float32 within 1e-4 of each table's
    largest entry; one float64 user sweep on the card against the dense
    oracle of tests/test_als.py (within 1e-8) and the batched Cholesky with
    NaN above the diagonal bit for bit the clean input's; then
    StreamingCholesky and StreamingLU at 12^3 float64 (unsymmetric values
    for LU) with a cap of STREAM_STAGE_ELEMS_CPU values, card against CPU
    within 1e-10."""
    import dataclasses
    import numpy as np
    import torch
    from spfx_torch import Config
    from spfx_torch.bench.als_bench import BENCH_CONFIG
    from spfx_torch.bench.kernel_probe import unsym_laplacian
    from spfx_torch.io import generate
    from spfx_torch.kernels import dense
    from spfx_torch.recsys import data as rdata
    from spfx_torch.recsys.als import ALSConfig, ALSModel
    from spfx_torch.stream import StreamingCholesky, StreamingLU
    inter = rdata.synthetic(943, 1682, avg_degree=106, rank=12, seed=0)
    for dtype, prec, tol in (("float64", "highest", 1e-10),
                             ("float32", "high", 1e-4)):
        cfg = dataclasses.replace(BENCH_CONFIG, dtype=dtype,
                                  matmul_precision=prec)
        mg = ALSModel(inter, cfg, device=dev)
        mc = ALSModel(inter, cfg, device="cpu")
        mg.fit_steps(2)
        mc.fit_steps(2)
        for name in ("U", "V"):
            g, c = getattr(mg, name).cpu(), getattr(mc, name)
            r = float((g - c).abs().max() / c.abs().max())
            log(f"[card vs cpu] ALS 100k rank 64 {dtype} {prec} {name} max "
                f"rel diff {r:.3e}")
            if not r <= tol:
                fail(f"ALS card and CPU {name} ({dtype} {prec}) differ by "
                     f"{r:.3e} (limit {tol:g})")
    # the dense oracle (tests/test_als.py:25) on the card
    rng = np.random.default_rng(0)
    R = (rng.random((12, 9)) < 0.4).astype(np.float64)
    us, its = np.nonzero(R)
    small = rdata.Interactions(12, 9, us.astype(np.int32),
                               its.astype(np.int32),
                               np.ones(len(us), np.float32))
    m = ALSModel(small, ALSConfig(rank=4, lam=0.3, alpha=5.0, user_cap=9,
                                  item_cap=12, chunk=8, dtype="float64",
                                  seed=1), device=dev)
    V0 = m.V[:9].cpu().numpy()
    U1 = m._sweep(m.V, m._u_idx_d, m._u_rat_d, m._lam, m._alpha)[:12]
    want = np.zeros((12, 4))
    for u in range(12):
        Cu = 1.0 + 5.0 * R[u]
        want[u] = np.linalg.solve(V0.T @ np.diag(Cu) @ V0 + 0.3 * np.eye(4),
                                  V0.T @ (Cu * (R[u] > 0)))
    err = float(np.abs(U1.cpu().numpy() - want).max())
    log(f"[card vs cpu] ALS user sweep against the dense oracle, float64: "
        f"max abs err {err:.3e}")
    if not err < 1e-8:
        fail(f"ALS user sweep on the card is {err:.3e} from the dense oracle")
    for dt in (torch.float32, torch.float64):
        X = torch.randn(512, 64, 70, dtype=dt, device=dev)
        S = X @ X.transpose(1, 2) + 64 * torch.eye(64, dtype=dt, device=dev)
        iu = torch.triu_indices(64, 64, 1, device=dev)
        Sn = S.clone()
        Sn[:, iu[0], iu[1]] = float("nan")
        if not torch.equal(dense.batched_cholesky(Sn),
                           dense.batched_cholesky(S)):
            fail(f"batched_cholesky read above the diagonal ({dt})")
    log("[card vs cpu] batched_cholesky at (512, 64), f32 and f64: NaN "
        "above the diagonal, factor bit for bit the clean input's")
    # the streaming engines at 12^3
    cfg = Config(dtype="float64")
    for lu, M in ((False, generate.laplacian_3d(GRID_CPU)),
                  (True, unsym_laplacian(GRID_CPU))):
        kind = StreamingLU if lu else StreamingCholesky
        sg = kind(M, cfg, stage_elems=STREAM_STAGE_ELEMS_CPU, device=dev)
        fg = sg.factorize(M)
        fc = kind(M, cfg, stage_elems=STREAM_STAGE_ELEMS_CPU,
                  device="cpu").factorize(M)
        for name, g, c in zip(("Lx", "Ux") if lu else ("L",),
                              factor_arrays(fg), factor_arrays(fc)):
            r = float((g - c).abs().max() / c.abs().max())
            log(f"[card vs cpu] stream {'LU unsym' if lu else 'Cholesky'} "
                f"{GRID_CPU}^3 f64, {len(sg.stages)} stages, {name} max rel "
                f"diff {r:.3e}")
            if not r <= 1e-10:
                fail(f"streamed card and CPU factors ({name}) differ by "
                     f"{r:.3e}")


# --------------------------------------------------------------------------
# phase 4i: the multi-device engines in a world of one NCCL rank; 6j: two
# gloo ranks on the one card
# --------------------------------------------------------------------------

MULTI_GRID = 16                    # phase 6j's matrices, laplacian_3d(16)
MULTI_RANKS = 2                    # phase 6j's ranks on the one card
MULTI_ENGINES = (("sharded", False), ("sharded", True), ("subtree", False),
                 ("subtree", True))


def start_group(backend: str = "nccl") -> str:
    """A process group of this process alone (a world of one rank) over
    ``backend``, meeting at a file in a fresh temporary directory; returns
    the directory."""
    import tempfile
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="spfx_group_")
    dist.init_process_group(backend, init_method="file://"
                            + os.path.join(tmp, "rdv"), world_size=1, rank=0)
    return tmp


def engine_class(name: str, lu: bool):
    from spfx_torch import dist
    return {("sharded", False): dist.ShardedCholesky,
            ("sharded", True): dist.ShardedLU,
            ("subtree", False): dist.SubtreeCholesky,
            ("subtree", True): dist.SubtreeLU}[name, lu]


def multidevice_predicted(ctx, first: bool) -> dict:
    """Launches of one factorization of a sharded or subtree context in a
    world of one rank. The sharded walk launches what the in-core eager
    walk does. The subtree engine's top phase launches that for the top
    plan, and its local phase (a MegaRunner over the rank's plan) twice
    that for the local plan at the first factorization (warm-up and
    capture) and nothing after it (one replay)."""
    import types
    if not hasattr(ctx, "top_plan"):
        return predicted_launches(ctx)
    of = lambda plan: predicted_launches(types.SimpleNamespace(
        plan=plan, config=ctx.config, lu=ctx.lu))
    want = of(ctx.top_plan)
    if first:
        loc = of(ctx.local_plan)
        want = {k: v + 2 * loc[k] for k, v in want.items()}
    return want


def all_reduces_predicted(ctx) -> int:
    """All-reduces of one factorization: per factor array, one a level
    phase that has buckets (the subtree engine's over its top plan, and
    its merge)."""
    plan = getattr(ctx, "top_plan", ctx.plan)
    n = sum(bool(lp.updates) + bool(lp.panels) for lp in plan.levels)
    n += hasattr(ctx, "top_plan")
    return n * (2 if ctx.lu else 1)


def sparse_factors(f):
    """A factor's triangles as scipy matrices: (L,), or LU's (L, U)."""
    return f.LU_sparse() if hasattr(f, "Ux") else (f.L_sparse(),)


def sparse_rel(a, b) -> float:
    """max |a - b| over max |b|, of two sparse matrices."""
    return float(abs(a - b).max() / abs(b).max())


def multidevice_phase(A, sym, defaults: dict, incore_peak: dict, dev,
                      als_ref, repeats: int = 3) -> dict:
    """4i. The multi-device engines at full width in a world of one NCCL
    rank (``start_group``): ShardedCholesky, ShardedLU, SubtreeCholesky
    and SubtreeLU at 48^3 f32 with the default Config on the 48^3
    analysis. For each: the first factorization's launches by kernel
    against ``multidevice_predicted`` and its all-reduces (count and
    bytes) against ``all_reduces_predicted``; ``repeats`` steady
    factorizations with the same checks (median wall); the peak device
    memory above the start beside the in-core path's; the refined
    residual (<= 1e-12); the factor against the in-core graph factor
    (phase 4 / 4b, ``defaults``) within 1e-5 of its largest entry, flat
    for the sharded engines (the same plan) and through L_sparse /
    LU_sparse for the subtree ones (their layout groups the supernodes
    by owner). Then ALSModel over the group's mesh on phase 4h's data and
    config: the slope per iteration beside 4h's, and the tables after the
    slope's iterations within 1e-5 of 4h's (``als_ref``). Returns {path:
    launches of the first factorization}."""
    import torch
    from spfx_torch import Config, scaled_residual, synth_rhs
    from spfx_torch.bench.als_bench import BENCH_CONFIG, slope
    from spfx_torch.chol.factorize import CholeskyFactor
    from spfx_torch.dist import make_mesh
    from spfx_torch.dist import mesh as dmesh
    from spfx_torch.kernels import _cuda, route
    from spfx_torch.lu.factorize import LUFactor
    from spfx_torch.recsys.als import ALSModel
    mesh = make_mesh("d")
    if mesh.size != 1 or mesh.group is None or mesh.device != dev:
        fail(f"multidevice: the group's mesh is {mesh}")
    paths, plans = {}, {}
    for name, lu in MULTI_ENGINES:
        key = "lu" if lu else "cholesky"
        label = f"{name} {key} {GRID}^3 float32"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        ctx = engine_class(name, lu)(A, Config(), mesh=mesh, sym=sym)
        setup_s = time.perf_counter() - t0
        if name == "sharded":
            plans[key] = ctx.plan          # the in-core plan
        nar = all_reduces_predicted(ctx)
        nbytes = nar * ctx.plan.storage * 4
        runs = []
        for i in range(1 + repeats):
            want = multidevice_predicted(ctx, first=i == 0)
            _cuda.reset_launch_counts()
            dmesh.reset_collective_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f = ctx.factorize(A)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            launches, coll = _cuda.launch_counts(), \
                dmesh.collective_counts()
            if i == 0:
                first_launches = launches
            if launches != want:
                fail(f"{label}: factorization {i} launched {launches}, the "
                     f"plans predict {want}")
            if (coll["all_reduce"], coll["all_reduce_bytes"]) \
                    != (nar, nbytes):
                fail(f"{label}: factorization {i} made {coll}; the plan "
                     f"predicts {nar} all-reduces of {nbytes} bytes")
        diag = "getrf_inv" if lu else "potrf_inv"
        if not all(first_launches[k] > 0 for k in ("window_gather2", diag,
                                                   "extend_add_rows")):
            fail(f"{label}: a kernel of the path was not launched: "
                 f"{first_launches}")
        peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
        if not all(bool(torch.isfinite(t).all()) for t in factor_arrays(f)):
            fail(f"{label}: factor has non-finite values")
        b = synth_rhs(A)
        res = scaled_residual(A, f.solve(b), b)
        ref = defaults[key][0]
        names = ("Lx", "Ux") if lu else ("L",)
        t0 = time.perf_counter()
        if name == "sharded":
            dist = {n: max_diff(a, r) / float(r.abs().max())
                    for n, a, r in zip(names, factor_arrays(f), ref)}
        else:
            incore = LUFactor(A, sym, plans[key], *ref, Config()) if lu \
                else CholeskyFactor(A, sym, plans[key], ref[0], Config())
            dist = {n: sparse_rel(a, r) for n, a, r in zip(
                ("L", "U") if lu else ("L",), sparse_factors(f),
                sparse_factors(incore))}
            del incore
        compare_s = time.perf_counter() - t0
        steady = statistics.median(runs[1:])
        rep = dict(engine=type(ctx).__name__, ranks=mesh.size,
                   backend="nccl", setup_s=setup_s,
                   plan_s=ctx.plan_time, first_factorize_s=runs[0],
                   factorize_s=steady, factorize_all_s=runs,
                   incore_factorize_s=defaults[key][1],
                   all_reduce=nar, all_reduce_bytes=nbytes,
                   all_reduce_gb=nbytes / 1e9,
                   launches_by_row={k: first_launches[k] for k in (
                       "window_gather2", diag, "extend_add_rows")},
                   launches=first_launches,
                   steady_launches=multidevice_predicted(ctx, first=False),
                   peak_rise_gb=peak, incore_peak_rise_gb=incore_peak[key],
                   residual=res, vs_incore=dist, compare_s=compare_s,
                   levels=len(ctx.plan.levels))
        if name == "subtree":
            rep.update(local_flops=ctx.local_flops, top_flops=ctx.top_flops,
                       top_levels=ctx.top_levels,
                       local_levels=len(ctx.local_plan.levels),
                       local_capture=ctx._runner.captures.get(
                           route.panel_mode()))
        log(f"[{label}] " + json.dumps(rep))
        if not res <= 1e-12:
            fail(f"{label}: scaled residual {res:.3e} > 1e-12")
        if not all(d <= 1e-5 for d in dist.values()):
            fail(f"{label}: {dist} of the largest entry from the in-core "
                 "graph factor's (limit 1e-5)")
        paths[f"{key}_{name}"] = first_launches
        del ctx, f
        torch.cuda.empty_cache()
    # the recommender over the group's mesh, against phase 4h's model
    train, U4h, V4h, per_iter4h = als_ref
    dmesh.reset_collective_counts()
    m = ALSModel(train, BENCH_CONFIG, mesh=mesh)
    per_iter, t = slope(m, ALS_ITERS)
    coll = dmesh.collective_counts()
    U, V = m.full_tables()
    dist = {n: max_diff(x, r) / float(r.abs().max())
            for n, x, r in (("U", U, U4h), ("V", V, V4h))}
    rep = dict(ranks=mesh.size, backend="nccl", graphs=m._fit_steps.graphs,
               capture=m._fit_steps.capture, fit_steps_s=t,
               per_iter_s=per_iter, per_iter_4h_s=per_iter4h,
               examples_per_sec=train.nnz * 2 / per_iter,
               all_gathers_counted=coll["all_gather"], vs_4h=dist)
    log("[multidevice recommender] " + json.dumps(rep))
    if not m._fit_steps.graphs:
        fail("multidevice recommender: fit_steps did not capture over NCCL")
    if not all(d <= 1e-5 for d in dist.values()):
        fail(f"multidevice recommender: tables {dist} of the largest entry "
             "from phase 4h's (limit 1e-5)")
    del m, U, V
    torch.cuda.empty_cache()
    return paths


def multi_rank_cases(mesh, grid: int) -> dict:
    """6j's work on one rank of ``mesh``: the four engines at
    laplacian_3d(grid) in float64 (LU on ``unsym_laplacian``'s values), and
    the recommender's "100k" shape at rank 64 in float64, fit_steps(2).
    Returns numpy arrays: the sharded factors flat, the subtree factors
    as CSC parts, the whole tables, and the launch counts."""
    import dataclasses
    import numpy as np
    from spfx_torch import Config
    from spfx_torch.bench.als_bench import BENCH_CONFIG
    from spfx_torch.bench.kernel_probe import unsym_laplacian
    from spfx_torch.io import generate
    from spfx_torch.kernels import _cuda
    from spfx_torch.recsys import data as rdata
    from spfx_torch.recsys.als import ALSModel
    out = {}
    A, Au = generate.laplacian_3d(grid), unsym_laplacian(grid)
    _cuda.reset_launch_counts()
    for name, lu in MULTI_ENGINES:
        M = Au if lu else A
        f = engine_class(name, lu)(M, Config(dtype="float64"),
                                   mesh=mesh).factorize(M)
        tag = f"{name}_{'lu' if lu else 'cholesky'}"
        if name == "sharded":
            for n, a in zip(("Lx", "Ux") if lu else ("L",), factor_arrays(f)):
                out[f"{tag}/{n}"] = a.cpu().numpy()
        else:
            for n, S in zip(("L", "U"), sparse_factors(f)):
                S = S.tocsc()
                for part in ("data", "indices", "indptr"):
                    out[f"{tag}/{n}.{part}"] = getattr(S, part)
    out["launches"] = np.asarray(json.dumps(_cuda.launch_counts()))
    inter = rdata.synthetic(943, 1682, avg_degree=106, rank=12, seed=0)
    m = ALSModel(inter, dataclasses.replace(BENCH_CONFIG, dtype="float64"),
                 mesh=mesh)
    m.fit_steps(2)
    out["als/U"], out["als/V"] = (t.cpu().numpy() for t in m.full_tables())
    return out


def multi_rank_worker(rank: int, tmp: str) -> None:
    """One of 6j's ranks: joins a gloo group of MULTI_RANKS on cuda:0,
    runs ``multi_rank_cases`` and writes them to ``tmp``."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.distributed as dist
    from spfx_torch.dist import init_distributed, make_mesh
    init_distributed(coordinator="file://" + os.path.join(tmp, "rdv"),
                     num_processes=MULTI_RANKS, process_id=rank,
                     device="cuda:0", backend="gloo")
    mesh = make_mesh("d")
    out = multi_rank_cases(mesh, MULTI_GRID)
    out["mesh"] = np.asarray([mesh.size, mesh.rank])
    np.savez(os.path.join(tmp, f"r{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def start_ranks() -> tuple:
    """Start 6j's MULTI_RANKS rank processes (``multi_rank_worker``), which
    run while the card-against-CPU phases do; returns (processes, their
    directory, the start time)."""
    import multiprocessing
    import tempfile
    tmp = tempfile.mkdtemp(prefix="spfx_ranks_")
    ctxm = multiprocessing.get_context("spawn")
    procs = [ctxm.Process(target=multi_rank_worker, args=(r, tmp))
             for r in range(MULTI_RANKS)]
    for p in procs:
        p.start()
    return procs, tmp, time.perf_counter()


def multi_rank_phase(ranks) -> dict:
    """6j. MULTI_RANKS ranks on the one card: NCCL refuses two ranks on one
    GPU, so spawned processes (``start_ranks``) join a gloo group over
    CUDA tensors on cuda:0 (``multi_rank_worker``). Each runs
    ``multi_rank_cases`` at MULTI_GRID^3 f64; every rank's results are
    held to the CPU's (the same cases on a CPU mesh of one device) and to
    the card's in a world of one NCCL rank (this process's group), within
    1e-10 of the largest entry: the sharded factors flat, the subtree
    factors through L_sparse / LU_sparse, the tables whole. Each rank's
    launch counters must be non-zero for every kernel of the path.
    Returns {path: launches} per rank."""
    import numpy as np
    import scipy.sparse as sp
    from spfx_torch.dist import make_mesh
    procs, tmp, t0 = ranks
    refs = {"cpu": multi_rank_cases(make_mesh(devices=["cpu"]), MULTI_GRID),
            "card, one NCCL rank": multi_rank_cases(make_mesh("d"),
                                                    MULTI_GRID)}
    for p in procs:
        p.join(600)
        if p.exitcode != 0:
            fail(f"multi-rank: a rank exited with {p.exitcode}")
    ranks_s = time.perf_counter() - t0

    def as_sparse(res, key):
        shape = (MULTI_GRID ** 3,) * 2
        return sp.csc_matrix((res[f"{key}.data"], res[f"{key}.indices"],
                              res[f"{key}.indptr"]), shape=shape)

    paths, worst = {}, {}
    for r in range(MULTI_RANKS):
        with np.load(os.path.join(tmp, f"r{r}.npz")) as z:
            got = {k: z[k] for k in z.files}
        if list(got["mesh"]) != [MULTI_RANKS, r]:
            fail(f"multi-rank: rank {r}'s mesh is {got['mesh']}")
        for ref_name, ref in refs.items():
            for key in ref:
                if key == "launches" or key.endswith((".indices",
                                                      ".indptr")):
                    continue
                if key.endswith(".data"):
                    k = key[:-len(".data")]
                    d = sparse_rel(as_sparse(got, k), as_sparse(ref, k))
                else:
                    k = key
                    d = float(np.abs(got[k] - ref[k]).max()
                              / np.abs(ref[k]).max())
                worst[(ref_name, k)] = max(worst.get((ref_name, k), 0.0), d)
                if not d <= 1e-10:
                    fail(f"multi-rank: rank {r}'s {k} is {d:.3e} of the "
                         f"largest entry from the {ref_name} result's")
        launches = json.loads(str(got["launches"]))
        for k in ("window_gather2", "extend_add_rows", "potrf_inv",
                  "getrf_inv"):
            if not launches[k] > 0:
                fail(f"multi-rank: rank {r} launched no {k}: {launches}")
        paths[f"ranks{MULTI_RANKS}_r{r}"] = launches
    log(f"[multi-rank] {MULTI_RANKS} gloo ranks on cuda:0, {MULTI_GRID}^3 "
        f"f64 (four engines) and the 100k recommender at rank 64: max rel "
        "diff " + json.dumps({f"{a} {b}": v for (a, b), v in worst.items()})
        + " launches " + json.dumps(paths)
        + f" ({ranks_s:.1f} s from the ranks' start, beside phases 6-6i)")
    return paths


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device():
    import torch
    return torch.device("cuda", 0)


# --------------------------------------------------------------------------

def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "spfx_torch")):
        print("chip_smoke: spfx_torch is not next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    _LOG.append(open(os.path.join(ROOT, "chiprun_out", "chip_smoke.log"),
                     "w"))
    def mark(phase: str) -> None:
        log(f"[phase] {phase} ends at {time.perf_counter() - t_start:.1f} s")

    import spfx_torch
    from spfx_torch import Config
    from spfx_torch.bench.kernel_probe import (magnetic_laplacian,
                                               plan_extend_calls,
                                               plan_getrf_calls,
                                               plan_potrf_calls,
                                               unsym_laplacian,
                                               ut_product_shapes)
    from spfx_torch.io import generate
    from spfx_torch.kernels import _cuda

    # 1. card
    smi = card_line()
    dev = device()
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    built = _cuda.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s for {sorted(built)}")
    for name, out in sorted(built.items()):
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    mark("2 build")

    # phase 4h's interactions, generated meanwhile in a spawned worker
    import concurrent.futures
    import multiprocessing
    als_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    als_data = als_pool.submit(generate_als_data, ALS_SHAPE)

    # 3. kernels against their plain versions, at the 48^3 plans' calls
    A = generate.laplacian_3d(GRID)
    ctx = spfx_torch.Cholesky(A, Config(), device=dev)
    log(f"[plan] grid {GRID}^3 analyze {ctx.analyze_time:.2f} s plan "
        f"{ctx.plan_time:.2f} s " + json.dumps(plan_summary(ctx)))
    # the pattern is symmetric, so the analysis of A + A^T that LU runs is
    # the Cholesky one: reuse it and skip a second host analysis
    lctx = spfx_torch.LU(A, Config(), sym=ctx.sym, device=dev)
    log(f"[plan] LU grid {GRID}^3 reuses the Cholesky analysis; plan "
        f"{lctx.plan_time:.2f} s " + json.dumps(plan_summary(lctx)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the complex and "high" phases (3d's complex calls, 3f, 3g) draw from
    # a generator of their own, so that the other phases' draws stay as
    # they were
    cgen = torch.Generator(device=dev)
    cgen.manual_seed(14)
    pcalls = plan_potrf_calls(ctx, dev)
    lcalls = plan_getrf_calls(lctx, dev)
    errs = {}
    rows = None
    for dtype in ("float32", "float64"):
        t0 = time.perf_counter()
        L, gcalls, gerr = check_gathers(ctx.plan, dtype, dev, gen)
        errs.update({(k, dtype): v for k, v in gerr.items()})
        errs[("potrf_inv", dtype)] = check_potrf(pcalls, dtype)
        check_potrf(narrow_potrf_calls(dev, gen), dtype)
        mixed, graded = edge_potrf_calls(dev)
        check_potrf([mixed], dtype)
        check_potrf([graded], dtype, local=True)
        errs[("getrf_inv", dtype)] = check_getrf(lcalls, dtype)
        check_getrf(narrow_getrf_calls(dev, gen), dtype)
        log(f"[kernels] {dtype}: {len(gcalls)} window_gather2 calls "
            f"bit-identical, {len(pcalls)} potrf_inv calls max abs err "
            f"{errs[('potrf_inv', dtype)]:.3e}, {len(lcalls)} getrf_inv "
            f"calls max abs err {errs[('getrf_inv', dtype)]:.3e} "
            f"({time.perf_counter() - t0:.1f} s)")
        if dtype == "float32":
            rows = kernel_rows(L, gcalls, pcalls, dtype)
            path = path_kernel_ms(L, gcalls, pcalls, dtype)
            for k, (ms, bms) in path.items():
                rows[k]["path_ms"] = ms
                rows[k]["path_bound_ms"] = bms
            rows["getrf_inv"] = getrf_rows(L, lcalls, dtype)
            log("[kernels] f32 timing " + json.dumps(rows))
        del L
    del pcalls, lcalls
    torch.cuda.empty_cache()

    mark("3 and 3b")

    # 3c. the whole-panel kernels at every PC step of the 48^3 plans
    for lu, c in ((False, ctx), (True, lctx)):
        calls = panel_calls(c, dev)
        kind = "lu" if lu else "chol"
        for dtype in ("float32", "float64"):
            t0 = time.perf_counter()
            worst = check_panels(calls, dtype, lu)
            errs.update({(k, dtype): v for k, v in worst.items()})
            log(f"[kernels] {dtype}: {len(calls)} calls each of "
                f"{kind}_panel_lanes and {kind}_panel_wide, max abs err "
                + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                + f" ({time.perf_counter() - t0:.1f} s)")
        edge = panel_edge_calls(dev, gen, lu)
        for dtype in ("float32", "float64"):
            worst = check_panels(edge, dtype, lu)
            log(f"[kernels] {dtype}: {len(edge)} seeded edge calls of "
                f"{kind}_panel_lanes and {kind}_panel_wide, (cp, rbp, B) = "
                + ", ".join(str((c[2], c[3], len(c[0]))) for c in edge)
                + ", max abs err "
                + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
        del edge
        prow = panel_rows(calls, "float32", lu)
        log(f"[kernels] f32 timing {kind} panels " + json.dumps(prow))
        rows.update(prow)
        del calls
        torch.cuda.empty_cache()

    mark("3c")

    # 3d. extend_add_rows at every UT step of the 48^3 Cholesky plan
    # and extend_add_rows2 at every UT step of the 48^3 LU plan
    ecalls = plan_extend_calls(ctx.plan, dev)
    lecalls = plan_extend_calls(lctx.plan, dev)
    for dtype in ("float32", "float64"):
        t0 = time.perf_counter()
        L = torch.randn(ctx.plan.storage, generator=gen, device=dev,
                        dtype=getattr(torch, dtype))
        err = check_extend_add(L, ecalls, dtype, gen)
        Lx, Ux = (torch.randn(lctx.plan.storage, generator=gen, device=dev,
                              dtype=L.dtype) for _ in range(2))
        err2 = check_extend_add(Lx, lecalls, dtype, gen, U=Ux)
        errs[("extend_add_rows", dtype)] = max(err, err2)
        log(f"[kernels] {dtype}: {len(ecalls)} extend_add_rows calls, max "
            f"abs err {err:.3e}; {len(lecalls)} extend_add_rows2 calls, "
            f"max abs err {err2:.3e}; for both, one slab row, all-dropped "
            "and single-value (csp 33, unaligned slab) calls exact "
            f"({time.perf_counter() - t0:.1f} s)")
        if dtype == "float32":
            rows["extend_add_rows"] = extend_add_rows_row(
                L, ecalls, dtype, gen, (Lx, Ux, lecalls))
            log("[kernels] f32 timing extend_add_rows "
                + json.dumps(rows["extend_add_rows"]))
        del L, Lx, Ux
    # the same calls and window_gather2 / window_gather at every UT step, on
    # complex flat arrays
    for dtype in ("complex64", "complex128"):
        t0 = time.perf_counter()
        L, gcalls, gerr = check_gathers(ctx.plan, dtype, dev, cgen)
        errs.update({(k, dtype): v for k, v in gerr.items()})
        err = check_extend_add(L, ecalls, dtype, cgen, edges=False)
        Lx, Ux = (torch.randn(lctx.plan.storage, generator=cgen, device=dev,
                              dtype=L.dtype) for _ in range(2))
        err2 = check_extend_add(Lx, lecalls, dtype, cgen, U=Ux, edges=False)
        errs[("extend_add_rows", dtype)] = max(err, err2)
        log(f"[kernels] {dtype}: {len(gcalls)} window_gather2 calls "
            f"bit-identical, {len(ecalls)} extend_add_rows calls, max abs "
            f"err {err:.3e}; {len(lecalls)} extend_add_rows2 calls, max abs "
            f"err {err2:.3e} ({time.perf_counter() - t0:.1f} s)")
        del L, Lx, Ux, gcalls
    del ecalls
    torch.cuda.empty_cache()

    mark("3d")

    # 3e. cholesky_small_batched (no path runs it)
    t0 = time.perf_counter()
    cerr = check_chol_small(dev, gen)
    check_chol_small_pivot(dev, gen)
    errs.update({("cholesky_small_batched", d): v for d, v in cerr.items()})
    rows["cholesky_small_batched"] = chol_small_row(dev, gen)
    log(f"[kernels] cholesky_small_batched at {len(CHOL_SMALL_SHAPES)} "
        "shapes (every c from 1 to 32 at batches 1, 3, 133), NaN and +Inf "
        f"junk, {len(CHOL_SMALL_OFFSET)} unaligned shapes and a negative "
        "pivot: max abs err "
        + ", ".join(f"{d} {v:.3e}" for d, v in cerr.items())
        + f" ({time.perf_counter() - t0:.1f} s); f32 timing "
        + json.dumps(rows["cholesky_small_batched"]))
    torch.cuda.empty_cache()

    mark("3e")

    # 3f. potrf_inv_c and getrf_inv_c at every diagonal-block call of the
    # complex64 48^3 plans: the magnetic Laplacian (Cholesky) and its
    # unsymmetric variant (LU), on the 48^3 analysis (the same pattern)
    Am = magnetic_laplacian(GRID)
    Amu = magnetic_laplacian(GRID, unsym=True)
    cctx = spfx_torch.Cholesky(Am, Config(dtype="complex64"), sym=ctx.sym,
                               device=dev)
    clctx = spfx_torch.LU(Amu, Config(dtype="complex64"), sym=ctx.sym,
                          device=dev)
    t0 = time.perf_counter()
    cpcalls = plan_potrf_calls(cctx, dev)
    clcalls = plan_getrf_calls(clctx, dev)
    for dtype in ("complex64", "complex128"):
        errs[("potrf_inv_c", dtype)] = check_potrf(cpcalls, dtype)
        errs[("getrf_inv_c", dtype)] = check_getrf(clcalls, dtype)
        for lu, check in ((False, check_potrf), (True, check_getrf)):
            for call in edge_diag_c_calls(dev, lu):
                check([call], dtype, local=True)
        log(f"[kernels] {dtype}: {len(cpcalls)} potrf_inv_c calls max abs "
            f"err {errs[('potrf_inv_c', dtype)]:.3e}, {len(clcalls)} "
            f"getrf_inv_c calls max abs err "
            f"{errs[('getrf_inv_c', dtype)]:.3e}; both at widths 0, 1, 7, "
            "8, 9, 31, 32 and scaled by 2^40, 2^70 and 2^-70, by row and "
            "column")
    rows.update(diag_c_rows(cpcalls, clcalls))
    log(f"[kernels] complex64 timing potrf_inv_c, getrf_inv_c "
        + json.dumps({k: rows[k] for k in ("potrf_inv_c", "getrf_inv_c")})
        + f" ({time.perf_counter() - t0:.1f} s)")
    del cpcalls, clcalls
    torch.cuda.empty_cache()

    mark("3f")

    # 3g. bmm_bf16x3 at the product shape of every UT step of the 48^3 f32
    # plans (LU's crossed products have the Cholesky step's shape)
    t0 = time.perf_counter()
    shapes = ut_product_shapes(ctx.plan)
    if ut_product_shapes(lctx.plan) != shapes:
        fail("the 48^3 LU plan's UT products differ from the Cholesky's")
    berr, rel3, rel1 = check_bf16x3(shapes, cgen, dev)
    errs[("bmm_bf16x3", "float32")] = berr
    rows["bmm_bf16x3"] = bmm_bf16x3_row(shapes, cgen, dev)
    log(f"[kernels] float32: {len(shapes)} bmm_bf16x3 calls read as they "
        f"lie and {len(COPIED_BF16X3)} copied first, max abs err "
        f"{berr:.3e} from the plain version; plain version's largest error "
        f"{rel3:.3e} of sum |a||b| against one bf16 pass's {rel1:.3e}; "
        f"timing " + json.dumps(rows["bmm_bf16x3"])
        + f" ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    mark("3g")

    # 4. Cholesky main path, 48^3 f32 with the default Config; 4c. the same
    # under SPFX_PANEL_KERNEL=lanes, then wide
    paths = {}
    graph_paths = {}
    device_ms = {}
    defaults = {}       # kind -> (the default factor's arrays, steady wall)
    incore_peak = {}    # kind -> the default path's peak memory rise, GB
    for lu, c, kind in ((False, ctx, "cholesky"), (True, lctx, "lu")):
        for mode in (None, "lanes", "wide"):
            path = kind if mode is None else f"{kind}_{mode}"
            label = (("LU " if lu else "main ") + f"{GRID}^3 float32"
                     + ("" if mode is None else f" {mode}"))
            with panel_env(mode):
                fp, paths[path], graph_paths[path], rp = main_path(
                    c, A, label,
                    extras=("graph", "solve") if mode is None else ())
                if mode is None:
                    defaults[kind] = (factor_arrays(fp), rp["factorize_s"])
                    incore_peak[kind] = rp["peak_rise_gb"]
                del fp
                if "--profile" in argv:
                    device_ms[path] = profile_pass(
                        c, A, "chip_smoke_profile" + ("_lu" if lu else "")
                        + ("" if mode is None else f"_{mode}"))
    mark("4, 4b and 4c")

    # 4j. the recorder's step stamps in phase 4's graphs, both kinds
    for lu, c in ((False, ctx), (True, lctx)):
        stamps_phase(c, A, f"{'LU' if lu else 'main'} {GRID}^3 float32")
    mark("4j")

    # 4d. UC buckets and the rowwin layout, both kinds, on the 48^3
    # analysis; the fused engine at 32^3 (its own analysis), cut from 48^3
    # to keep the script's time as the phases of complex and "high" grew
    A32f = generate.laplacian_3d(GRID_F64)
    sym32 = None
    for lu in (False, True):
        for tag, kw in LAYOUT_CONFIGS:
            kind = spfx_torch.LU if lu else spfx_torch.Cholesky
            fused = tag == "rowwin_fused"
            M, grid = (A32f, GRID_F64) if fused else (A, GRID)
            lc = kind(M, Config(**kw), sym=sym32 if fused else ctx.sym,
                      device=dev)
            if fused:
                sym32 = lc.sym
            path = f"{'lu' if lu else 'cholesky'}_{tag}"
            label = f"{'LU' if lu else 'main'} {grid}^3 float32 {tag}"
            log(f"[plan] {label}: plan {lc.plan_time:.2f} s "
                + json.dumps(plan_summary(lc)))
            extras = {"uc": ("replay", "graph"),
                      "rowwin": ("replay", "graph", "solve")}.get(
                          tag, ("replay",))
            _, paths[path], graph_paths[path], _ = main_path(
                lc, M, label, extras=extras)
            del lc
            torch.cuda.empty_cache()
    del A32f, sym32
    if device_ms:
        log("[profile] device ms by path " + json.dumps(device_ms))

    mark("4d")

    # 4e. complex64 at 48^3 with the default Config but the dtype: the
    # magnetic Laplacian (Cholesky) and its unsymmetric variant (LU)
    for lu, c, M in ((False, cctx, Am), (True, clctx, Amu)):
        path = "lu_c64" if lu else "cholesky_c64"
        _, paths[path], graph_paths[path], _ = main_path(
            c, M, f"{'LU' if lu else 'main'} {GRID}^3 complex64",
            extras=("graph",))
        torch.cuda.empty_cache()
    del cctx, clctx, c, Am, Amu
    torch.cuda.empty_cache()

    mark("4e")

    # 4f. update_precision="high" at 48^3 f32, both kinds, on the 48^3
    # analysis: the capture's bmm_bf16x3 launches, the graph against the
    # eager walk, and the factor's distance from the default precision's
    # (phase 4) within 1e-3 of each array's largest entry: each bf16x3
    # update product errs by up to about 3 x 2^-16 (4.6e-5) of sum |a||b|
    # where full float32 errs by 2^-24 k, and the limit leaves a factor of
    # 20 for the growth over the elimination
    for lu, kind in ((False, "cholesky"), (True, "lu")):
        hk = spfx_torch.LU if lu else spfx_torch.Cholesky
        hc = hk(A, Config(update_precision="high"), sym=ctx.sym, device=dev)
        label = f"{'LU' if lu else 'main'} {GRID}^3 float32 high"
        fh, paths[f"{kind}_high"], graph_paths[f"{kind}_high"], rh = \
            main_path(hc, A, label, extras=("replay",))
        dist = {}
        for name, h, d in zip(("Lx", "Ux") if lu else ("L",),
                              factor_arrays(fh), defaults[kind][0]):
            dist[name] = max_diff(h, d) / float(d.abs().max())
            if not dist[name] <= 1e-3:
                fail(f"{label}: {name} is {dist[name]:.3e} of its largest "
                     "entry from the default precision's (limit 1e-3)")
        log(f"[{label}] distance from the default precision's factor "
            f"{json.dumps(dist)}; steady wall {rh['factorize_s']:.4f} s "
            f"beside the default config's {defaults[kind][1]:.4f} s")
        del hc, fh
        torch.cuda.empty_cache()
    mark("4f")

    # 4g. the stage-streamed engines at 48^3 f32, on the 48^3 analysis: the
    # walks of the default path over rebased stage buffers
    paths.update(streaming_phase(A, ctx.sym, defaults, incore_peak, dev))
    sym48 = ctx.sym
    del ctx, lctx
    torch.cuda.empty_cache()

    mark("4g")

    # 4h. the recommender at als_bench's full width, the "20m" shape with a
    # fifth of its users
    _, als_ref = recommender_phase(dev, als_data)
    als_pool.shutdown()
    del als_data
    torch.cuda.empty_cache()

    mark("4h")

    # 4i. the multi-device engines and the row-sharded recommender in a
    # world of one NCCL rank, against phases 4, 4b and 4h
    import torch.distributed as dist
    start_group("nccl")
    paths.update(multidevice_phase(A, sym48, defaults, incore_peak, dev,
                                   als_ref))
    del defaults, als_ref, sym48
    torch.cuda.empty_cache()

    mark("4i")

    # 5. f64 at 32^3; 5c. the same under lanes, without refinement
    A32 = generate.laplacian_3d(GRID_F64)
    ctx64 = spfx_torch.Cholesky(A32, Config(dtype="float64"), device=dev)
    main_path(ctx64, A32, f"f64 {GRID_F64}^3 float64", extras=("solve",))
    with panel_env("lanes"):
        main_path(ctx64, A32, f"f64 {GRID_F64}^3 float64 lanes",
                  unrefined_limit=1e-12)
    del ctx64

    # 5b. LU in f64 at 32^3, unsymmetric values; 5c. the same under wide,
    # without refinement
    A32u = unsym_laplacian(GRID_F64)
    lctx64 = spfx_torch.LU(A32u, Config(dtype="float64"), device=dev)
    log(f"[plan] LU unsym {GRID_F64}^3 analyze {lctx64.analyze_time:.2f} s "
        f"plan {lctx64.plan_time:.2f} s, max |A - A^T| "
        f"{abs(A32u - A32u.T).max():.3f}")
    main_path(lctx64, A32u, f"LU unsym {GRID_F64}^3 float64",
              extras=("solve",))
    with panel_env("wide"):
        main_path(lctx64, A32u, f"LU unsym {GRID_F64}^3 float64 wide",
                  unrefined_limit=1e-12)
    del lctx64

    # 5d. complex128 at 32^3, both kinds (the double-complex line), with
    # the device solve report
    Am32 = magnetic_laplacian(GRID_F64)
    cctx128 = spfx_torch.Cholesky(Am32, Config(dtype="complex128"),
                                  device=dev)
    main_path(cctx128, Am32, f"complex128 {GRID_F64}^3", extras=("solve",))
    Amu32 = magnetic_laplacian(GRID_F64, unsym=True)
    clctx128 = spfx_torch.LU(Amu32, Config(dtype="complex128"),
                             sym=cctx128.sym, device=dev)
    main_path(clctx128, Amu32, f"LU complex128 {GRID_F64}^3",
              extras=("solve",))
    del cctx128, clctx128, Am32, Amu32
    torch.cuda.empty_cache()

    mark("5, 5b, 5c and 5d")

    # 6j's ranks start here and run beside the card-against-CPU phases
    ranks = start_ranks()

    # 6. the card against the CPU (plain versions), 12^3 f64, Cholesky and
    # (6b) LU with unsymmetric values, both flat factors; 6c. the same
    # under each panel route
    A12 = generate.laplacian_3d(GRID_CPU)
    A12u = unsym_laplacian(GRID_CPU)
    cfg = Config(dtype="float64")
    for mode in (None, "lanes", "wide", "mixed"):
        tag = "" if mode is None else f" {mode}"
        with panel_env(mode):
            Lg = spfx_torch.cholesky(A12, cfg, device=dev).L.cpu()
            Lc = spfx_torch.cholesky(A12, cfg, device="cpu").L
            fg = spfx_torch.lu(A12u, cfg, device=dev)
            fc = spfx_torch.lu(A12u, cfg, device="cpu")
        for name, g, c in (("L", Lg, Lc), ("LU unsym Lx", fg.Lx, fc.Lx),
                           ("LU unsym Ux", fg.Ux, fc.Ux)):
            rel = float((g.cpu() - c).abs().max() / c.abs().max())
            log(f"[card vs cpu] {GRID_CPU}^3 f64{tag} {name} max rel diff "
                f"{rel:.3e}")
            if not rel <= 1e-10:
                fail(f"card and CPU factors ({name}{tag}) differ by "
                     f"{rel:.3e}")

    # 6f. the same under the configs of phase 4d
    for tag, kw in LAYOUT_CONFIGS:
        cfg = Config(dtype="float64", **kw)
        fgs = (spfx_torch.cholesky(A12, cfg, device=dev),
               spfx_torch.lu(A12u, cfg, device=dev))
        fcs = (spfx_torch.cholesky(A12, cfg, device="cpu"),
               spfx_torch.lu(A12u, cfg, device="cpu"))
        for fg, fc in zip(fgs, fcs):
            for name, g, c in zip(("L",) if fg is fgs[0]
                                  else ("LU unsym Lx", "LU unsym Ux"),
                                  factor_arrays(fg), factor_arrays(fc)):
                rel = float((g.cpu() - c).abs().max() / c.abs().max())
                log(f"[card vs cpu] {GRID_CPU}^3 f64 {tag} {name} max rel "
                    f"diff {rel:.3e}")
                if not rel <= 1e-10:
                    fail(f"card and CPU factors ({name} {tag}) differ by "
                         f"{rel:.3e}")

    # 6g. the same in complex128 on the magnetic Laplacians, under the
    # default config and the three of phase 4d; then matmul_precision="high"
    # in f32 on the real matrices, within 1e-4 of each array's largest
    # entry: both sides run bf16x3 products and float32 diagonal blocks,
    # the card's kernels summing in other orders than the CPU's plain
    # versions (phase 3's f32 kernel tolerance)
    M12, M12u = (magnetic_laplacian(GRID_CPU),
                 magnetic_laplacian(GRID_CPU, unsym=True))
    for tag, kw, mats, tol in (
            [("complex128", dict(dtype="complex128"), (M12, M12u), 1e-10)]
            + [(f"complex128 {t}", dict(dtype="complex128", **k),
                (M12, M12u), 1e-10) for t, k in LAYOUT_CONFIGS]
            + [("f32 high", dict(dtype="float32", matmul_precision="high"),
                (A12, A12u), 1e-4)]):
        cfg = Config(**kw)
        fgs = (spfx_torch.cholesky(mats[0], cfg, device=dev),
               spfx_torch.lu(mats[1], cfg, device=dev))
        fcs = (spfx_torch.cholesky(mats[0], cfg, device="cpu"),
               spfx_torch.lu(mats[1], cfg, device="cpu"))
        for fg, fc in zip(fgs, fcs):
            for name, g, c in zip(("L",) if fg is fgs[0] else ("LU Lx",
                                                              "LU Ux"),
                                  factor_arrays(fg), factor_arrays(fc)):
                rel = float((g.cpu() - c).abs().max() / c.abs().max())
                log(f"[card vs cpu] {GRID_CPU}^3 {tag} {name} max rel diff "
                    f"{rel:.3e}")
                if not rel <= tol:
                    fail(f"card and CPU factors ({name} {tag}) differ by "
                         f"{rel:.3e} (limit {tol:g})")

    mark("6, 6b, 6c, 6f and 6g")

    # 6h. the UT gathers at windows that are not a multiple of 1024
    # elements: the kernel against its plain version, then the two configs
    # whose plans build such windows, card against CPU
    t0 = time.perf_counter()
    check_odd_windows(dev, cgen)
    for tag, kw in ODD_WINDOW_CONFIGS:
        for dtype, tol in (("float64", 1e-10), ("float32", 1e-4)):
            cfg = Config(dtype=dtype, **kw)
            fgs = (spfx_torch.cholesky(A12, cfg, device=dev),
                   spfx_torch.lu(A12u, cfg, device=dev))
            fcs = (spfx_torch.cholesky(A12, cfg, device="cpu"),
                   spfx_torch.lu(A12u, cfg, device="cpu"))
            for fg, fc in zip(fgs, fcs):
                odd = sorted({wa for _, wa, _, _ in gather_calls(fg.plan, dev)
                              if wa % 1024})
                if not odd:
                    fail(f"{tag}: the {GRID_CPU}^3 plan holds no UT window "
                         "that is not a multiple of 1024")
                for name, g, c in zip(("L",) if fg is fgs[0]
                                      else ("LU unsym Lx", "LU unsym Ux"),
                                      factor_arrays(fg), factor_arrays(fc)):
                    rel = float((g.cpu() - c).abs().max() / c.abs().max())
                    log(f"[card vs cpu] {GRID_CPU}^3 {dtype} {tag} {name} "
                        f"(windows {odd}) max rel diff {rel:.3e}")
                    if not rel <= tol:
                        fail(f"card and CPU factors ({name} {tag} {dtype}) "
                             f"differ by {rel:.3e} (limit {tol:g})")
    log(f"[kernels] window_gather2 at windows of 1,280, 1,536 and 1,027 "
        f"(f32, complex128) or 1,025 (f64, complex64) elements bit for bit, "
        f"dead windows included; both odd-window configs card against CPU "
        f"({time.perf_counter() - t0:.1f} s)")

    mark("6h")

    # 6i. the recommender and the stage-streamed engines, card against CPU
    t0 = time.perf_counter()
    card_vs_cpu_recsys_stream(dev)
    log(f"[card vs cpu] recommender and streaming engines "
        f"({time.perf_counter() - t0:.1f} s)")

    mark("6i")

    # 6j. two gloo ranks on the one card, against the CPU and the world of
    # one NCCL rank
    paths.update(multi_rank_phase(ranks))
    dist.destroy_process_group()

    mark("6j")

    # 6e. the surfaces: CLI, checkpoints, profile scope
    t0 = time.perf_counter()
    surfaces(dev)
    surfaces_complex(dev)
    log(f"[surfaces] CLI, checkpoints and profile scope at {GRID_CPU}^3, "
        f"the CLI and checkpoints also complex "
        f"({time.perf_counter() - t0:.1f} s)")

    mark("6e")

    # 6d. syrk_gemm_batched on both of its paths, then the panel bench,
    # its launches a path of its own
    t0 = time.perf_counter()
    serr, spaths = check_syrk_gemm(dev, gen)
    log(f"[kernels] syrk_gemm_batched at (batch, n, m, k) = "
        + ", ".join(map(str, SYRK_SHAPES)) + f", calls by path {spaths}, "
        "max abs err " + ", ".join(f"{d} {v:.3e}" for d, v in serr.items()))
    _, paths["panels"], rows["syrk_gemm_batched"], berr = panel_bench(dev)
    errs[("syrk_gemm_batched", "float32")] = max(berr, serr["float32"])
    log(f"[panels] custom kernel vs einsum max abs err {berr:.3e}, launches "
        f"{paths['panels']['syrk_gemm_batched']} "
        f"({time.perf_counter() - t0:.1f} s); f32 timing "
        + json.dumps(rows["syrk_gemm_batched"]))
    torch.cuda.empty_cache()

    mark("6d")

    # 7. the kernels line: launches from the kernel's own path (window
    # gathers, extend_add_rows and potrf_inv: Cholesky; getrf_inv: LU; each
    # whole-panel kernel: its kind under its route; syrk_gemm_batched: the
    # panel bench), every path listed
    cu = "spfx_torch/kernels/csrc/"
    pb = "spfx/kernels/pallas_blocks.py:"
    info = {  # name: (source, TPU kernel, own path)
        "window_gather2": (cu + "window_gather.cu", pb + "100", "cholesky"),
        "window_gather": (cu + "window_gather.cu", pb + "48", "cholesky"),
        "potrf_inv": (cu + "potrf_inv.cu", pb + "1074", "cholesky"),
        "getrf_inv": (cu + "getrf_inv.cu", pb + "1138", "lu"),
        "chol_panel_lanes": (cu + "panel_lanes.cu", pb + "386",
                             "cholesky_lanes"),
        "lu_panel_lanes": (cu + "panel_lanes.cu", pb + "526", "lu_lanes"),
        "chol_panel_wide": (cu + "panel_wide.cu", pb + "807",
                            "cholesky_wide"),
        "lu_panel_wide": (cu + "panel_wide.cu", pb + "969", "lu_wide"),
        "extend_add_rows": (cu + "extend_add.cu", pb + "611", "cholesky"),
        "syrk_gemm_batched": (cu + "syrk_gemm.cu", pb + "200", "panels"),
        "cholesky_small_batched": (cu + "chol_small.cu", pb + "1195",
                                   "cholesky"),
        # no Pallas kernel: the JAX package's complex panels take XLA's
        # Cholesky and its no-pivot LU, its "high" products XLA's bf16x3
        "potrf_inv_c": (cu + "potrf_inv_c.cu", "spfx/kernels/blocks.py:352",
                        "cholesky_c64"),
        "getrf_inv_c": (cu + "getrf_inv_c.cu", "spfx/kernels/blocks.py:842",
                        "lu_c64"),
        "bmm_bf16x3": (cu + "bmm_bf16x3.cu", "spfx/kernels/mega.py:383",
                       "cholesky_high"),
    }
    kernels = []
    for name, (source, replaces, own) in info.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[own][name],
            "launches_by_path": {p: l[name] for p, l in paths.items()},
            "graph_launches": graph_paths.get(own, {}).get(name),
            "max_abs_err": errs[(name, "complex64" if name.endswith("_c")
                                 else "float32")], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "path_ms": r.get("path_ms"),
            "path_bound_ms": r.get("path_bound_ms"),
            "library_path_ms": r.get("library_path_ms"),
            "library_device_ms": r.get("library_device_ms"),
            "library_path_device_ms": r.get("library_path_device_ms"),
            "ms_b1": r.get("ms_b1"), "ms_b256": r.get("ms_b256"),
            "lu_path_ms": r.get("lu_path_ms"),
            "lu_path_bound_ms": r.get("lu_path_bound_ms"),
            "library_tf32_ms": r.get("library_tf32_ms"),
            "ms_c128": r.get("ms_c128"), "ms_b1_c128": r.get("ms_b1_c128"),
            "path_ms_c128": r.get("path_ms_c128"),
            "bound_ms_c128": r.get("bound_ms_c128")})
    for k in kernels:
        for v in k.values():
            if isinstance(v, float) and not math.isfinite(v):
                fail(f"non-finite number in the kernels line: {k}")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    _LOG.pop().close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
