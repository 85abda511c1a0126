"""The frozen bound arithmetic against hand counts on the plans of
laplacian_3d(6), Cholesky and LU."""

import math

import numpy as np
import pytest
import torch

from portbench import bounds
from portbench.families.gen57pt import Family

CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=["cholesky", "lu"])
def plan(request):
    import spfx_torch
    f = Family(dict(grid=6, operator="shifted_poisson", shift_lo=0.01,
                    shift_hi=0.01))
    A = f.matrix(f.values(np.random.default_rng(0), 1)[0])
    kind = spfx_torch.LU if request.param == "lu" else spfx_torch.Cholesky
    return kind(A, spfx_torch.Config(), device="cpu").plan


def ut_steps(plan):
    return [ub for lp in plan.levels for ub in lp.updates]


def test_bound():
    assert bounds.bound(3.35e9, 0.0, "float32") == (1.0, "bytes")
    assert bounds.bound(0.0, 67e9, "float32") == (1.0, "operations")
    assert bounds.bound(1.0, 34e9, "float64") == (1.0, "operations")


def test_gather_bytes_by_hand(plan):
    item = 4
    hand = 0
    steps = ut_steps(plan)
    assert steps
    for ub in steps:
        wa = (ub.mp + 1024 // ub.kp) * ub.kp
        wb = ub.tgt_cpos.shape[1] * ub.kp
        for s in ub.src_start:
            hand += (wa * (2 if s >= 0 else 1)) * item + 4
        for s in ub.head_start:
            hand += (wb * (2 if s >= 0 else 1)) * item + 4
    calls = bounds.gather_calls(plan, CPU)
    assert len(calls) == len(steps)
    assert sum(bounds.gather_bytes(c, item) for c in calls) == hand
    for arrays in (1, 2):
        assert bounds.path_bound_ms(plan, "window_gather2", "float32",
                                    arrays) == pytest.approx(
            arrays * hand / 3.35e12 * 1e3)


def hand_blocks(plan):
    """(widths of each task in the block, nb) of every diagonal-block call,
    by hand."""
    out = []
    for lp in plan.levels:
        for pb in lp.panels:
            for s in range(0, pb.cp, 32):
                nb = min(32, pb.cp - s)
                out.append(([min(max(int(w) - s, 0), nb) for w in pb.widths],
                            nb))
    return out


def test_diag_calls_by_hand(plan):
    calls = bounds.plan_diag_calls(plan)
    hand = hand_blocks(plan)
    assert len(calls) == len(hand) == sum(
        math.ceil(pb.cp / 32) for lp in plan.levels for pb in lp.panels)
    for (wrel, nb), (ws, hnb) in zip(calls, hand):
        assert nb == hnb and wrel.tolist() == ws


@pytest.mark.parametrize("kind", ["potrf_inv", "getrf_inv"])
def test_diag_work_by_hand(plan, kind):
    item = 4
    hb = hf = 0.0
    for ws, nb in hand_blocks(plan):
        for w in ws:
            if kind == "potrf_inv":
                hb += w * (w + 1) / 2 * item + 2 * nb * nb * item + 4
                hf += 2 / 3 * w ** 3
            else:
                hb += w * w * item + 4 * nb * nb * item + 4
                hf += 2 / 3 * w ** 3 + 2 / 3 * w ** 3
    work = bounds.potrf_work if kind == "potrf_inv" else bounds.getrf_work
    got = [work(w, nb, item) for w, nb in bounds.plan_diag_calls(plan)]
    assert sum(b for b, _ in got) == pytest.approx(hb, rel=1e-12)
    assert sum(o for _, o in got) == pytest.approx(hf, rel=1e-12)
    assert bounds.path_bound_ms(plan, kind, "float32", 1) == pytest.approx(
        max(hb / 3.35e12, hf / 67e12) * 1e3, rel=1e-12)


def test_extend_add_by_hand(plan):
    item = 4
    calls = bounds.plan_extend_calls(plan, CPU)
    steps = ut_steps(plan)
    assert len(calls) == len(steps)
    for (lo, srows, csp, rows), ub in zip(calls, steps):
        assert (lo, srows, csp) == (int(ub.slab_lo[0]), ub.slab_rows,
                                    ub.csp)
        table = [int(r) for r in ub.tgt_lrow.reshape(-1)]
        assert rows.tolist() == table
        live = [r for r in table if r >= 0]
        hand = (len(live) + 2 * len(set(live))) * csp * item \
            + 4 * len(table)
        assert bounds.extend_add_bytes(rows, csp, item) == hand
