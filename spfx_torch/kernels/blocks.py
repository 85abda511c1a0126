"""Batched dense-block numeric primitives of the Cholesky main path.

Port of the main-path part of spfx/kernels/blocks.py. Everything is batched
over one bucket of same-padded supernode tasks and works IN PLACE on the
one flat factor tensor ``L`` (the JAX functions return a new array; here
the slab or panel block is a view of ``L`` and is updated where it lies).

- assembly: the permuted lower-triangle values scattered into fresh storage;
- UT update step: two superwindow gathers (``gather.window_gather2``), the
  masked product C = G H^T, C's columns placed at their target columns, and
  the extend-add of the valid rows into the target slab;
- PC panel step: the NB = 32 blocked panel factorization, whose diagonal
  blocks go through ``panel.potrf_inv``; the panel solves and the trailing
  updates are batched matrix products.
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import gather, panel
from spfx_torch.plan.schedule import ALIGN

NB = panel.NB


def assemble(idx, vals, storage: int):
    """Scatter the permuted lower-triangle entry values into a fresh flat
    panel array (``idx`` holds distinct positions)."""
    L = torch.zeros(storage, dtype=vals.dtype, device=vals.device)
    L[idx] = vals
    return L


def _col_mask(widths, cp: int, dtype):
    return (torch.arange(cp, device=widths.device)[None, :]
            < widths[:, None]).to(dtype)


def _row_mask(nrows, rp: int, dtype):
    return (torch.arange(rp, device=nrows.device)[None, :]
            < nrows[:, None]).to(dtype)


def _rng_mask(rstart, mrows, rows: int, dtype):
    """Row-validity mask of a superwindow: rows [rstart, rstart+mrows)."""
    mi = torch.arange(rows, device=rstart.device)[None, :]
    return ((mi >= rstart[:, None])
            & (mi < (rstart + mrows)[:, None])).to(dtype)


# --------------------------------------------------------------------------
# Cholesky panel: blocked NB-column steps around potrf_inv
# --------------------------------------------------------------------------

def _chol_deltas_blocked(Draw, Braw, widths, nbelow, cp: int, rbp: int):
    """Cholesky panel deltas (new - old) of task-major blocks Draw
    (B, cp, cp) / Braw (B, rbp, cp): NB-column block steps whose only
    serial work is the batched potrf + explicit inverse of the (NB, NB)
    diagonal block; the column-panel solve is Pb @ inv^T and the trailing
    update a batched product."""
    B = widths.shape[0]
    cm = _col_mask(widths, cp, Draw.dtype)
    D = Draw * cm[:, None, :] * cm[:, :, None]
    if rbp:
        rm = _row_mask(nbelow, rbp, Draw.dtype)
        M = torch.cat([D, Braw * cm[:, None, :] * rm[:, :, None]], dim=1)
    else:
        M = D
    for s in range(0, cp, NB):
        e = min(s + NB, cp)
        wrel = (widths - s).clamp(0, e - s).to(torch.int32)
        Lss, inv = panel.potrf_inv(wrel, M[:, s:e, s:e].contiguous())
        # X L^T = Pb  ->  X = Pb @ inv^T
        Pcol = torch.bmm(M[:, e:, s:e], inv.transpose(1, 2))
        M[:, s:e, s:e] = Lss
        M[:, e:, s:e] = Pcol
        if e < cp:
            # rows of Pcol aligned to the future columns are its leading
            # cp - e rows
            M[:, e:, e:] -= torch.bmm(Pcol, Pcol[:, :cp - e, :]
                                      .transpose(1, 2))
    # the trailing updates touched the diag window's upper half (zero by
    # the storage contract); mask L11 back to lower so dD is zero there
    L11 = torch.tril(M[:, :cp, :])
    dD = (L11 - Draw) * cm[:, None, :] * cm[:, :, None]
    if rbp:
        dB = (M[:, cp:, :] - Braw) * cm[:, None, :] * rm[:, :, None]
    else:
        dB = Draw.new_zeros((B, 0, cp))
    return dD, dB


def factor_panels_chol_u(L, widths, nbelow, slab_lo: int, cp: int, rbp: int):
    """Factor one uniform panel bucket IN PLACE: the bucket's B panels are
    contiguous at [slab_lo, slab_lo + B*(cp+rbp)*cp) with task stride
    (cp+rbp)*cp (see PanelBucketC)."""
    B = widths.shape[0]
    S = (cp + rbp) * cp
    blk = L[slab_lo:slab_lo + B * S].view(B, cp + rbp, cp)
    dd, db = _chol_deltas_blocked(blk[:, :cp, :], blk[:, cp:, :],
                                  widths, nbelow, cp, rbp)
    blk[:, :cp, :] += dd
    if rbp:
        blk[:, cp:, :] += db
    return L


# --------------------------------------------------------------------------
# M-tiled update step (UT buckets)
# --------------------------------------------------------------------------

def _pair_gather_aligned(L, starts_a, rows_a: int, starts_b, rows_b: int,
                         kp: int):
    """Source-tile and head superwindows of one step in ONE launch."""
    A_, B_ = gather.window_gather2(L, starts_a, rows_a * kp,
                                   starts_b, rows_b * kp)
    return (A_.view(starts_a.shape[0], rows_a, kp),
            B_.view(starts_b.shape[0], rows_b, kp))


def update_rows_sym_t(L, kw, mrows, rstart, src_start, head_start,
                      tgt_cpos, mp: int, kp: int, csp: int):
    """Update rows E (B, mp + ALIGN/kp, csp) of one M-tiled bucket: each
    batch item is one (<= mp)-row source tile in its superwindow (true rows
    at [rstart, rstart+mrows)), against its task's head window (k-masked to
    the source width kw). C = G H^T's column n lands at target column
    tgt_cpos[n]; columns with tgt_cpos == -1 are dropped. The placement is
    a scatter in place of the JAX package's one-hot product, and as exact:
    each target column receives at most one live C column."""
    ext = ALIGN // kp
    rows_g = mp + ext
    B, np_h = tgt_cpos.shape
    G, H = _pair_gather_aligned(L, src_start, rows_g, head_start, np_h, kp)
    G = G * _rng_mask(rstart, mrows, rows_g, L.dtype)[:, :, None]
    H = H * _col_mask(kw, kp, L.dtype)[:, None, :]
    C = torch.bmm(G, H.transpose(1, 2))                  # (B, rows_g, np_h)
    # dropped columns are zeroed and added onto column 0: adding exact
    # zeros leaves E exactly C's placement
    live = tgt_cpos >= 0
    C = C * live[:, None, :].to(C.dtype)
    col = torch.where(live, tgt_cpos, 0).to(torch.int64)
    E = C.new_zeros((B, rows_g, csp))
    return E.scatter_add_(2, col[:, None, :].expand(B, rows_g, np_h), C)


def extend_add_slab(L, slab_lo: int, ea_idx, ea_rbase, ea_rel, E,
                    srows: int, csp: int):
    """Subtract the valid update rows of E (B, rows, csp) into the slab
    L[slab_lo : slab_lo + srows*csp] viewed as (srows, csp), IN PLACE: the
    plan's group tables pair E row ea_idx[g*EA_G + i] with slab row
    ea_rbase[g] + ea_rel[g, i] (ea_rel < 0 pads a group). Several E rows
    may target one slab row; on the card their sum order is not fixed."""
    slab = L[slab_lo:slab_lo + srows * csp].view(srows, csp)
    rel = ea_rel.reshape(-1)
    live = rel >= 0
    rows = torch.where(live, ea_rbase.repeat_interleave(ea_rel.shape[1])
                       + rel, 0)
    Ec = E.reshape(-1, E.shape[-1]).index_select(0, ea_idx)
    slab.index_add_(0, rows, Ec * live[:, None].to(E.dtype), alpha=-1)
    return L


def apply_updates_sym_t(L, kw, mrows, rstart, src_start, head_start,
                        slab_lo: int, ea_idx, ea_rbase, ea_rel, tgt_cpos,
                        mp: int, kp: int, csp: int, srows: int):
    """One UT update step, in place: update rows, then extend-add."""
    E = update_rows_sym_t(L, kw, mrows, rstart, src_start, head_start,
                          tgt_cpos, mp, kp, csp)
    return extend_add_slab(L, slab_lo, ea_idx, ea_rbase, ea_rel, E,
                           srows, csp)
