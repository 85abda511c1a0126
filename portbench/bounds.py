"""The yardstick of the kernel rooflines: the published peaks of the card
and the work that the plan's calls need, computed from the plan's tables.

Frozen copies. Each function below is a copy of the program's own metric
arithmetic, made when this benchmark was defined, so that a later change to
the program cannot move the yardstick: the source is named on each. Only
``plan_diag_calls`` is new: ``plan_potrf_calls`` / ``plan_getrf_calls``
(``spfx_torch/bench/kernel_probe.py:360,386``) without the blocks' values,
which the work does not depend on.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet (copied from chip_smoke.py:225-228): dense
# rates, without sparsity, at the full 700 W power limit; a complex type
# runs at its parts' real rate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,    # non-tensor-core rates
              "float64": 34e12,
              "complex64": 67e12,
              "complex128": 34e12}
# real operations a complex operation takes, against one real: a complex
# multiply-add is four real multiply-adds
COMPLEX_OPS = 4

ALIGN = 1024    # spfx_torch/plan/schedule.py:903, the UT superwindow grain
NB = 32         # spfx_torch/kernels/panel.py:43, the diagonal block size


def bound(nbytes: float, ops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of the type.
    (chip_smoke.py:306-311)"""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def gather_calls(plan, dev):
    """(starts_a, win_a, starts_b, win_b) of every UT step of the plan.
    (chip_smoke.py:319-328)"""
    out = []
    for lp in plan.levels:
        for ub in lp.updates:
            t = ub.to(dev)
            ext = ALIGN // ub.kp
            out.append((t[3], (ub.mp + ext) * ub.kp, t[4],
                        ub.tgt_cpos.shape[1] * ub.kp))
    return out


def gather_bytes(call, itemsize: int) -> float:
    """(chip_smoke.py:331-335)"""
    sa, wa, sb, wb = call
    live = int((sa >= 0).sum()) * wa + int((sb >= 0).sum()) * wb
    total = sa.shape[0] * wa + sb.shape[0] * wb
    return float((live + total) * itemsize + 4 * (sa.shape[0] + sb.shape[0]))


def potrf_work(wrel, nb: int, item: int):
    """(bytes, operations) that potrf_inv must spend on one call: each
    block reads the lower triangle of its live w x w part, w(w+1)/2
    values, and its wrel entry, and writes L and L^{-1}, 2 nb^2 values;
    the Cholesky and the triangular inverse take w^3/3 flops each.
    (chip_smoke.py:478-486)"""
    w = wrel.clamp(0, nb).double()
    nbytes = (float((w * (w + 1) / 2).sum()) * item
              + 2.0 * wrel.shape[0] * nb * nb * item + 4.0 * wrel.shape[0])
    return nbytes, float((2.0 / 3.0 * w ** 3).sum())


def getrf_work(wrel, nb: int, item: int):
    """(bytes, operations) that getrf_inv must spend on one call: each
    block reads its live w x w part (both triangles), w^2 values, and its
    wrel entry, and writes L, U, L^{-1} and U^{-1}, 4 nb^2 values; the LU
    takes 2/3 w^3 flops and the two triangular inverses w^3/3 each.
    (chip_smoke.py:489-497)"""
    w = wrel.clamp(0, nb).double()
    nbytes = (float((w * w).sum()) * item
              + 4.0 * wrel.shape[0] * nb * nb * item + 4.0 * wrel.shape[0])
    return nbytes, float((2.0 / 3.0 * w ** 3 + 2.0 * w ** 3 / 3.0).sum())


def plan_diag_calls(plan):
    """(wrel, nb) of every diagonal-block call (potrf_inv or getrf_inv) of
    the plan: each PC bucket's panels in blocks of NB columns, wrel the
    live width of each panel's block (the loop of
    spfx_torch/bench/kernel_probe.py:386-405 without the blocks)."""
    out = []
    for lp in plan.levels:
        for pb in lp.panels:
            widths = torch.as_tensor(pb.widths, dtype=torch.int64)
            for s in range(0, pb.cp, NB):
                e = min(s + NB, pb.cp)
                wrel = (widths - s).clamp(0, e - s).to(torch.int32)
                out.append((wrel, e - s))
    return out


def plan_extend_calls(plan, dev):
    """(slab_lo, srows, csp, rows) of every UT step of the plan: the
    step's slab of the flat factor and its row table (one entry per row of
    the step's E). (spfx_torch/bench/kernel_probe.py:750-755)"""
    return [(int(ub.slab_lo[0]), ub.slab_rows, ub.csp, ub.to(dev)[6])
            for lp in plan.levels for ub in lp.updates]


def extend_add_bytes(rows, csp: int, item: int) -> float:
    """Bytes that one extend_add_rows call must move: each live row of E
    read once, each distinct slab row it names read and written once (rows
    of E that share a slab row share its traffic), plus the table.
    (spfx_torch/bench/kernel_probe.py:758-764)"""
    live = rows[rows >= 0]
    return float((live.numel() + 2 * torch.unique(live).numel()) * csp * item
                 + 4 * rows.shape[0])


def path_work(plan, kernel: str, dtype: str, arrays: int):
    """(bytes, operations) of all of one factorization's calls of
    ``kernel`` ("window_gather2", "potrf_inv" or "getrf_inv"), from the
    plan's tables; ``arrays`` is the number of factor arrays that each UT
    step gathers from (1 for Cholesky, 2 for LU). A value of ``dtype``
    takes its element size; a complex one's operations are counted as
    real ones."""
    item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    if kernel == "window_gather2":
        nbytes = sum(gather_bytes(c, item)
                     for c in gather_calls(plan, torch.device("cpu")))
        return arrays * nbytes, 0.0
    work = potrf_work if kernel == "potrf_inv" else getrf_work
    done = [work(w, nb, item) for w, nb in plan_diag_calls(plan)]
    ops = sum(o for _, o in done)
    if dtype.startswith("complex"):
        ops *= COMPLEX_OPS
    return sum(b for b, _ in done), ops


def path_bound_ms(plan, kernel: str, dtype: str, arrays: int) -> float:
    """The least time the card could take for all of one factorization's
    calls of ``kernel`` (as ``path_work``)."""
    return bound(*path_work(plan, kernel, dtype, arrays), dtype)[0]
