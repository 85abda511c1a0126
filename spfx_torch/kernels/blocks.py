"""Batched dense-block numeric primitives of the Cholesky and LU main paths.

Port of the main-path part of spfx/kernels/blocks.py. Everything is batched
over one bucket of same-padded supernode tasks and works IN PLACE on the
flat factor tensors (``L`` for Cholesky, the twins ``Lx`` and ``Ux`` for
LU; the JAX functions return new arrays, here the slab or panel block is a
view of the flat tensor and is updated where it lies).

- assembly: the permuted lower-triangle values scattered into fresh storage;
- UT update step: two superwindow gathers (``gather.window_gather2``), the
  masked product C = G H^T, C's columns placed at their target columns, and
  the extend-add of the valid rows into the target slab
  (``extend_add.extend_add_rows`` over the bucket's flat ``tgt_lrow``);
- PC panel step: the routers ``_chol_deltas_blocks`` and
  ``_lu_deltas_blocks`` pick a kernel family per bucket with
  ``route.route_panel`` under the ``SPFX_PANEL_KERNEL`` mode the engine
  read: the default NB = 32 blocked panel factorization, whose diagonal
  blocks go through ``panel.potrf_inv`` (LU: ``panel.getrf_inv``) and whose
  panel solves and trailing updates are batched matrix products, or one
  whole-panel kernel per bucket (``panel_lanes``, ``panel_wide``).

LU stores L (unit diagonal, zeros above it) in ``Lx`` and U^T (U's
diagonal on its diagonal) in ``Ux``, slot for slot in the same panel
layout; an LU step runs the Cholesky step's gathers once per array, with
crossed products (C_L = G_L H_U^T, C_U = G_U H_L^T), and one twin
extend-add (``extend_add.extend_add_rows2``) into both arrays.

The non-default bucket kinds, none of which reaches a Pallas kernel in
the JAX package:

- UC update step (``Config(update_tile=0)``): one contiguous (mp x kp)
  source window per task at an unaligned start (``_task_gather``, plain
  indexing, as JAX's XLA gather), the product against the window's
  leading rows, the column placement, then the same ``extend_add_rows``
  launch (LU: ``extend_add_rows2``) over the bucket's flat ``tgt_lrow`` as
  the UT step: the port's form of ``extend_add_slab``.
- rowwin layout (``Config(layout="rowwin")``): one window per panel row
  (``_win_gather``; ``_win_scatter_add``, an ``index_add_``, for the
  write-back), start < 0 reading zeros and dropping the row. The U step
  is gather, product, placement, scatter. The P step gathers the diagonal
  and below blocks and sends them through the same routers as the PC
  step (``_chol_deltas_blocks``, ``_lu_deltas_blocks``), so
  ``panel.potrf_inv`` / ``panel.getrf_inv`` and the ``SPFX_PANEL_KERNEL``
  routes run there too; JAX factors these blocks with ``lax.linalg``,
  which the port would have to run as library calls, while the routers'
  deltas are already held against JAX's at the same tolerances.

- level solves (the device solve): ``solve_fwd_level_c`` and
  ``solve_bwd_level_c`` (PC buckets), ``solve_fwd_level`` and
  ``solve_bwd_level`` (rowwin P buckets) solve one bucket's diagonal
  blocks against the right-hand sides and carry the below blocks'
  products to the rows below, in place on x (n + 1, nrhs). No Pallas
  kernel computes them in the JAX package (off the TPU its triangular
  solves are ``lax.linalg.triangular_solve``), so they are library calls
  here: ``torch.linalg.solve_triangular`` and ``matmul.bmm``.

Complex factors (complex64, complex128) run every step above. Cholesky is
Hermitian, A = L L^H, so its products and solves take the conjugate
transpose where the real path takes the transpose (``_ht``): the blocked
panel's Pb L^{-H} and trailing Pcol Pcol^H, every update's C = G H^H, and
the backward solve's L21^H and L11^H, as the JAX package's ``_conj`` sites
do. LU never conjugates: U is stored transposed (``Ux`` holds U^T), not
conjugated. Complex panels always take the blocked path
(``route.route_panel``).

Every batched product goes through ``matmul.bmm``, which runs float32
products as three bf16 passes under the JAX precision "high" and is
``torch.bmm`` otherwise.
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import (extend_add, gather, matmul, panel,
                                panel_lanes, panel_wide, route)
from spfx_torch.kernels.panel_lanes import to_lanes, to_task_major
from spfx_torch.plan.schedule import ALIGN

NB = panel.NB


def assemble(idx, vals, storage: int):
    """Scatter the permuted lower-triangle entry values into a fresh flat
    panel array (``idx`` holds distinct positions)."""
    L = torch.zeros(storage, dtype=vals.dtype, device=vals.device)
    L[idx] = vals
    return L


def _ht(x):
    """The conjugate transpose of a batch of matrices (the transpose of a
    real one)."""
    return x.transpose(1, 2).conj()


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
    diagonal block; the column-panel solve is Pb @ inv^H and the trailing
    update a batched product (conjugate transposes: A = L L^H)."""
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
        # X L^H = Pb  ->  X = Pb @ inv^H
        Pcol = matmul.bmm(M[:, e:, s:e], _ht(inv))
        M[:, s:e, s:e] = Lss
        M[:, e:, s:e] = Pcol
        if e < cp:
            # rows of Pcol aligned to the future columns are its leading
            # cp - e rows
            M[:, e:, e:] -= matmul.bmm(Pcol, _ht(Pcol[:, :cp - e, :]))
    # the trailing updates touched the diag window's upper half (zero by
    # the storage contract); mask L11 back to lower so dD is zero there
    L11 = torch.tril(M[:, :cp, :])
    dD = (L11 - Draw) * cm[:, None, :] * cm[:, :, None]
    if rbp:
        dB = (M[:, cp:, :] - Braw) * cm[:, None, :] * rm[:, :, None]
    else:
        dB = Draw.new_zeros((B, 0, cp))
    return dD, dB


def _chol_deltas_blocks(Draw, Braw, widths, nbelow, cp: int, rbp: int,
                        mode: str = "blocked"):
    """Cholesky panel deltas (dD, dB) of task-major blocks Draw
    (B, cp, cp) / Braw (B, rbp, cp), by the route ``route.route_panel``
    gives the class under ``mode``: the blocked path, the lanes kernel (in
    its (rows, cp, B) layout, there and back) or the wide kernel."""
    B = widths.shape[0]
    r = route.route_panel(cp, rbp, B, Draw.element_size(), mode=mode,
                          cplx=Draw.is_complex())
    if r == "lanes":
        ddT, dbT = panel_lanes.chol_panel_deltas_lanes(
            widths, nbelow, to_lanes(Draw), to_lanes(Braw), cp, rbp)
        return to_task_major(ddT), to_task_major(dbT)
    if r == "wide":
        return panel_wide.chol_panel_deltas_wide(
            widths, nbelow, Draw.contiguous(), Braw.contiguous(), cp, rbp)
    return _chol_deltas_blocked(Draw, Braw, widths, nbelow, cp, rbp)


def _panel_block(L, slab_lo: int, B: int, cp: int, rbp: int):
    """The (B, cp + rbp, cp) block of a uniform panel bucket's B tasks."""
    return L[slab_lo:slab_lo + B * (cp + rbp) * cp].view(B, cp + rbp, cp)


def factor_panels_chol_u(L, widths, nbelow, slab_lo: int, cp: int, rbp: int,
                         mode: str = "blocked", out=None):
    """Factor one uniform panel bucket IN PLACE: the bucket's B panels are
    contiguous at [slab_lo, slab_lo + B*(cp+rbp)*cp) with task stride
    (cp+rbp)*cp (see PanelBucketC). ``mode`` is the panel-kernel mode
    (``route.panel_mode()``). With ``out`` (a flat array of L's layout)
    the deltas are added there and L is only read; returns the array
    written."""
    B = widths.shape[0]
    out = L if out is None else out
    blk = _panel_block(L, slab_lo, B, cp, rbp)
    dd, db = _chol_deltas_blocks(blk[:, :cp, :], blk[:, cp:, :],
                                 widths, nbelow, cp, rbp, mode)
    tgt = _panel_block(out, slab_lo, B, cp, rbp)
    tgt[:, :cp, :] += dd
    if rbp:
        tgt[:, cp:, :] += db
    return out


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
    the source width kw). C = G H^H's column n lands at target column
    tgt_cpos[n] (``_place_cols``)."""
    rows_g = mp + ALIGN // kp
    np_h = tgt_cpos.shape[1]
    G, H = _pair_gather_aligned(L, src_start, rows_g, head_start, np_h, kp)
    G = G * _rng_mask(rstart, mrows, rows_g, L.dtype)[:, :, None]
    H = H * _col_mask(kw, kp, L.dtype)[:, None, :]
    return _place_cols(matmul.bmm(G, _ht(H)), tgt_cpos, csp)


def _place_cols(C, tgt_cpos, csp: int):
    """E (B, rows, csp) with C (B, rows, np_h)'s column n at tgt_cpos[n];
    columns with tgt_cpos == -1 are dropped. A scatter in place of the JAX
    package's one-hot product, and as exact: each target column receives
    at most one live C column."""
    B, rows, np_h = C.shape
    # dropped columns are zeroed and added onto column 0: adding exact
    # zeros leaves E exactly C's placement
    live = tgt_cpos >= 0
    C = C * live[:, None, :].to(C.dtype)
    col = torch.where(live, tgt_cpos, 0).to(torch.int64)
    E = C.new_zeros((B, rows, csp))
    return E.scatter_add_(2, col[:, None, :].expand(B, rows, np_h), C)


def slab_view(L, slab_lo: int, srows: int, csp: int):
    """The slab L[slab_lo : slab_lo + srows*csp] of a flat array, viewed as
    (srows, csp)."""
    return L[slab_lo:slab_lo + srows * csp].view(srows, csp)


def apply_updates_sym_t(L, kw, mrows, rstart, src_start, head_start,
                        slab_lo: int, tgt_rows, tgt_cpos, mp: int, kp: int,
                        csp: int, srows: int, out=None):
    """One UT update step, in place: update rows E (B, rows, csp), then one
    ``extend_add.extend_add_rows`` launch that subtracts E's valid rows
    from the slab of L at slab_lo (``slab_view``): E row i lands on slab
    row tgt_rows[i] (the bucket's flat ``tgt_lrow``, -1 drops the row).
    Several E rows may target one slab row; on the card their sum order is
    not fixed. With ``out`` (a flat array of L's layout) E is subtracted
    from out's slab and L is only read; returns the array written."""
    out = L if out is None else out
    E = update_rows_sym_t(L, kw, mrows, rstart, src_start, head_start,
                          tgt_cpos, mp, kp, csp)
    extend_add.extend_add_rows(slab_view(out, slab_lo, srows, csp), tgt_rows,
                               E.reshape(-1, csp))
    return out


# --------------------------------------------------------------------------
# LU: the same steps over the twin arrays Lx (L) and Ux (U^T)
# --------------------------------------------------------------------------

def update_rows_lu_t(Lx, Ux, kw, mrows, rstart, src_start, head_start,
                     tgt_cpos, mp: int, kp: int, csp: int):
    """LU update rows (EL, EU) of one M-tiled bucket: the superwindows of
    update_rows_sym_t gathered from each array over the same starts, then
    the crossed products CL = GL HU^T and CU = GU HL^T (H k-masked, G
    row-masked), each placed by tgt_cpos."""
    rows_g = mp + ALIGN // kp
    np_h = tgt_cpos.shape[1]
    rm = _rng_mask(rstart, mrows, rows_g, Lx.dtype)[:, :, None]
    km = _col_mask(kw, kp, Lx.dtype)[:, None, :]
    GL, HL = _pair_gather_aligned(Lx, src_start, rows_g, head_start, np_h,
                                  kp)
    GU, HU = _pair_gather_aligned(Ux, src_start, rows_g, head_start, np_h,
                                  kp)
    CL = matmul.bmm(GL * rm, (HU * km).transpose(1, 2))
    CU = matmul.bmm(GU * rm, (HL * km).transpose(1, 2))
    return _place_cols(CL, tgt_cpos, csp), _place_cols(CU, tgt_cpos, csp)


def apply_updates_lu_t(Lx, Ux, kw, mrows, rstart, src_start, head_start,
                       slab_lo: int, tgt_rows, tgt_cpos, mp: int, kp: int,
                       csp: int, srows: int, out=None):
    """One LU UT update step, in place on Lx and Ux: update rows, then one
    ``extend_add.extend_add_rows2`` launch that subtracts EL's valid rows
    from Lx's slab and EU's from Ux's, both at the same offset and rows (on
    the card their sum order is not fixed). With ``out`` (a pair of flat
    arrays) the rows are subtracted there instead."""
    EL, EU = update_rows_lu_t(Lx, Ux, kw, mrows, rstart, src_start,
                              head_start, tgt_cpos, mp, kp, csp)
    return _extend2(out or (Lx, Ux), slab_lo, srows, csp, tgt_rows, EL, EU)


def _extend2(out, slab_lo: int, srows: int, csp: int, tgt_rows, EL, EU):
    """The twin extend-add of an LU update step into the pair ``out``;
    returns it."""
    tx, tu = out
    extend_add.extend_add_rows2(
        slab_view(tx, slab_lo, srows, csp), slab_view(tu, slab_lo, srows, csp),
        tgt_rows, EL.reshape(-1, csp), EU.reshape(-1, csp))
    return tx, tu


def _task_gather(L, starts, rows: int, win: int):
    """(B,) task starts -> (B, rows, win) contiguous blocks of L; start < 0
    gives zeros."""
    return _win_gather(L, starts[:, None], rows * win).view(
        starts.shape[0], rows, win)


# --------------------------------------------------------------------------
# UC update step (Config(update_tile=0)): one contiguous window per task
# --------------------------------------------------------------------------

def _sym_rows(G, tgt_cpos, csp: int):
    """Update rows E = C placed by tgt_cpos, C = G G_N^H, where the N block
    G_N is G's leading Np rows (UC and rowwin U steps)."""
    np_ = tgt_cpos.shape[1]
    return _place_cols(matmul.bmm(G, _ht(G[:, :np_, :])), tgt_cpos, csp)


def _lu_rows(GL, GU, tgt_cpos, csp: int):
    """LU update rows (EL, EU): the crossed products CL = GL GU_N^T and
    CU = GU GL_N^T, each placed by tgt_cpos (see _sym_rows)."""
    np_ = tgt_cpos.shape[1]
    CL = matmul.bmm(GL, GU[:, :np_, :].transpose(1, 2))
    CU = matmul.bmm(GU, GL[:, :np_, :].transpose(1, 2))
    return _place_cols(CL, tgt_cpos, csp), _place_cols(CU, tgt_cpos, csp)


def update_rows_sym_c(L, kw, mrows, src_start, tgt_cpos, mp: int, kp: int,
                      csp: int):
    """Update rows E (B, mp, csp) of one UC bucket: each task's contiguous
    (mp x kp) source window (k-masked to kw, row-masked to mrows) against
    its own leading rows (the N block)."""
    G = _task_gather(L, src_start, mp, kp) \
        * _col_mask(kw, kp, L.dtype)[:, None, :] \
        * _row_mask(mrows, mp, L.dtype)[:, :, None]
    return _sym_rows(G, tgt_cpos, csp)


def apply_updates_sym_c(L, kw, mrows, src_start, slab_lo: int, tgt_rows,
                        tgt_cpos, mp: int, kp: int, csp: int, srows: int,
                        out=None):
    """One UC update step, in place: update rows, then one
    ``extend_add.extend_add_rows`` launch into the slab at slab_lo, as
    ``apply_updates_sym_t`` (``out`` too)."""
    out = L if out is None else out
    E = update_rows_sym_c(L, kw, mrows, src_start, tgt_cpos, mp, kp, csp)
    extend_add.extend_add_rows(slab_view(out, slab_lo, srows, csp), tgt_rows,
                               E.reshape(-1, csp))
    return out


def update_rows_lu_c(Lx, Ux, kw, mrows, src_start, tgt_cpos, mp: int,
                     kp: int, csp: int):
    """LU update rows (EL, EU) of one UC bucket: the windows of
    update_rows_sym_c from each array, crossed (``_lu_rows``)."""
    m = _col_mask(kw, kp, Lx.dtype)[:, None, :] \
        * _row_mask(mrows, mp, Lx.dtype)[:, :, None]
    return _lu_rows(_task_gather(Lx, src_start, mp, kp) * m,
                    _task_gather(Ux, src_start, mp, kp) * m, tgt_cpos, csp)


def apply_updates_lu_c(Lx, Ux, kw, mrows, src_start, slab_lo: int, tgt_rows,
                       tgt_cpos, mp: int, kp: int, csp: int, srows: int,
                       out=None):
    """One LU UC update step, in place on Lx and Ux: update rows, then one
    ``extend_add.extend_add_rows2`` launch, as ``apply_updates_lu_t``
    (``out`` too)."""
    EL, EU = update_rows_lu_c(Lx, Ux, kw, mrows, src_start, tgt_cpos, mp, kp,
                              csp)
    return _extend2(out or (Lx, Ux), slab_lo, srows, csp, tgt_rows, EL, EU)


# --------------------------------------------------------------------------
# rowwin layout: one window per panel row
# --------------------------------------------------------------------------

def _win_gather(L, starts, win: int):
    """(B, X) row starts -> (B, X, win) windows of L; start < 0 reads
    zeros."""
    live = starts >= 0
    idx = (torch.where(live, starts, 0).long()[..., None]
           + torch.arange(win, device=L.device))
    return torch.where(live[..., None], L[idx], 0)


def _win_scatter_add(L, starts, upd, alpha: float = 1.0):
    """L[s : s + win] += alpha * upd row by row, in place, for row starts
    ``starts`` (any shape) and rows ``upd`` (starts.shape + (win,)); start
    < 0 drops the row. Windows may overlap (``index_add_`` sums them); a
    dropped row adds exact zeros at the start of L."""
    win = upd.shape[-1]
    if starts.numel() == 0 or win == 0:
        return L
    starts = starts.reshape(-1)
    live = starts >= 0
    idx = (torch.where(live, starts, 0).long()[:, None]
           + torch.arange(win, device=L.device))
    vals = torch.where(live[:, None], upd.reshape(-1, win), 0)
    return L.index_add_(0, idx.reshape(-1), vals.reshape(-1), alpha=alpha)


def update_rows_sym(L, kw, src_row_start, tgt_cpos, kp: int, csp: int):
    """Update rows E (B, Mp, csp) of one rowwin U bucket: the source rows'
    kp-windows (k-masked to kw) against their leading Np rows."""
    G = _win_gather(L, src_row_start, kp) \
        * _col_mask(kw, kp, L.dtype)[:, None, :]
    return _sym_rows(G, tgt_cpos, csp)


def apply_updates_sym(L, kw, src_row_start, tgt_row_start, tgt_cpos,
                      kp: int, csp: int, out=None):
    """One rowwin U step, in place: L[tgt_row_start] -= E, row by row (into
    ``out`` instead, given one)."""
    E = update_rows_sym(L, kw, src_row_start, tgt_cpos, kp, csp)
    return _win_scatter_add(L if out is None else out, tgt_row_start, E,
                            alpha=-1.0)


def update_rows_lu(Lx, Ux, kw, src_row_start, tgt_cpos, kp: int, csp: int):
    """LU update rows (EL, EU) of one rowwin U bucket: the windows of
    update_rows_sym from each array, crossed (``_lu_rows``)."""
    km = _col_mask(kw, kp, Lx.dtype)[:, None, :]
    return _lu_rows(_win_gather(Lx, src_row_start, kp) * km,
                    _win_gather(Ux, src_row_start, kp) * km, tgt_cpos, csp)


def apply_updates_lu(Lx, Ux, kw, src_row_start, tgt_row_start, tgt_cpos,
                     kp: int, csp: int, out=None):
    """One LU rowwin U step, in place on Lx and Ux (on the pair ``out``,
    given one)."""
    EL, EU = update_rows_lu(Lx, Ux, kw, src_row_start, tgt_cpos, kp, csp)
    tx, tu = out or (Lx, Ux)
    _win_scatter_add(tx, tgt_row_start, EL, alpha=-1.0)
    _win_scatter_add(tu, tgt_row_start, EU, alpha=-1.0)
    return tx, tu


def panel_deltas_chol(L, widths, nbelow, diag_row_start, below_row_start,
                      mode: str = "blocked"):
    """Cholesky panel deltas (dD (B, cp, cp), dB (B, rbp, cp)) of one
    rowwin P bucket, through ``_chol_deltas_blocks``."""
    cp, rbp = diag_row_start.shape[1], below_row_start.shape[1]
    return _chol_deltas_blocks(_win_gather(L, diag_row_start, cp),
                               _win_gather(L, below_row_start, cp),
                               widths, nbelow, cp, rbp, mode)


def factor_panels_chol(L, widths, nbelow, diag_row_start, below_row_start,
                       mode: str = "blocked", out=None):
    """Factor one rowwin P bucket IN PLACE: the deltas added back row by
    row (dead columns carry exact zeros, so overlapping windows are
    untouched); into ``out`` instead, given one."""
    dD, dB = panel_deltas_chol(L, widths, nbelow, diag_row_start,
                               below_row_start, mode)
    out = L if out is None else out
    _win_scatter_add(out, diag_row_start, dD)
    return _win_scatter_add(out, below_row_start, dB)


def panel_deltas_lu(Lx, Ux, widths, nbelow, diag_row_start,
                    below_row_start, mode: str = "blocked"):
    """LU panel deltas (dDL, dBL, dDU, dBU) of one rowwin P bucket, through
    ``_lu_deltas_blocks``."""
    cp, rbp = diag_row_start.shape[1], below_row_start.shape[1]
    DL, DU, BL, BU = (_win_gather(F, starts, cp)
                      for starts in (diag_row_start, below_row_start)
                      for F in (Lx, Ux))
    return _lu_deltas_blocks(DL, DU, BL, BU, widths, nbelow, cp, rbp, mode)


def factor_panels_lu(Lx, Ux, widths, nbelow, diag_row_start,
                     below_row_start, mode: str = "blocked", out=None):
    """Factor one rowwin LU P bucket IN PLACE on Lx and Ux (on the pair
    ``out``, given one)."""
    dDL, dBL, dDU, dBU = panel_deltas_lu(Lx, Ux, widths, nbelow,
                                         diag_row_start, below_row_start,
                                         mode)
    tx, tu = out or (Lx, Ux)
    _win_scatter_add(tx, diag_row_start, dDL)
    _win_scatter_add(tx, below_row_start, dBL)
    _win_scatter_add(tu, diag_row_start, dDU)
    _win_scatter_add(tu, below_row_start, dBU)
    return tx, tu


def lu_front(DLraw, DUraw, widths):
    """The square LU front Mf (B, cp, cp) of a panel bucket's diagonal
    windows, masked to the live width: L side on and below the diagonal
    (DL's lower part), U side above it (DU's strict lower part,
    transposed)."""
    cp = DLraw.shape[-1]
    cm = _col_mask(widths, cp, DLraw.dtype)
    mm = cm[:, None, :] * cm[:, :, None]
    return (torch.tril(DLraw * mm)
            + torch.tril(DUraw * mm, -1).transpose(1, 2)), mm


def _lu_deltas_blocked(DLraw, DUraw, BLraw, BUraw, widths, nbelow,
                       cp: int, rbp: int):
    """LU panel deltas (dDL, dBL, dDU, dBU) of task-major blocks: NB-column
    block steps whose only serial work is the batched no-pivot LU + the
    explicit L and U inverses of the (NB, NB) diagonal block; the panel
    solves (L side below: P Uinv; U side row block: Linv A; U^T below:
    P Linv^T) and the trailing updates are batched products."""
    B = widths.shape[0]
    dt = DLraw.dtype
    cm = _col_mask(widths, cp, dt)
    Mf, mmask = lu_front(DLraw, DUraw, widths)
    if rbp:
        bm = cm[:, None, :] * _row_mask(nbelow, rbp, dt)[:, :, None]
        PL = BLraw * bm
        PU = BUraw * bm
    for s in range(0, cp, NB):
        e = min(s + NB, cp)
        wrel = (widths - s).clamp(0, e - s).to(torch.int32)
        Lb, Ub, Linv, Uinv = panel.getrf_inv(wrel,
                                             Mf[:, s:e, s:e].contiguous())
        # L side below the block: X U = P  ->  X = P Uinv
        PbL = torch.cat([Mf[:, e:, s:e], PL[:, :, s:e]], dim=1) if rbp \
            else Mf[:, e:, s:e]
        Lcol = matmul.bmm(PbL, Uinv)
        Ld = Lcol[:, :cp - e, :]            # rows e..cp <-> future columns
        Mf[:, s:e, s:e] = torch.tril(Lb, -1) + Ub
        if e < cp:
            # U side row block: L U12 = A  ->  U12 = Linv A (unit L)
            U12 = matmul.bmm(Linv, Mf[:, s:e, e:])
            Mf[:, s:e, e:] = U12
            Mf[:, e:, s:e] = Ld
            Mf[:, e:, e:] -= matmul.bmm(Ld, U12)
        if rbp:
            # U^T below the panel: X L^T = P (unit)  ->  X = P Linv^T
            U12t_pu = matmul.bmm(PU[:, :, s:e], Linv.transpose(1, 2))
            Lp = Lcol[:, cp - e:, :]
            if e < cp:
                PL[:, :, e:] -= matmul.bmm(Lp, U12)
                PU[:, :, e:] -= matmul.bmm(U12t_pu, Ld.transpose(1, 2))
            PL[:, :, s:e] = Lp
            PU[:, :, s:e] = U12t_pu
    L11 = torch.tril(Mf, -1) + torch.eye(cp, dtype=dt, device=Mf.device)
    U11t = torch.triu(Mf).transpose(1, 2)
    dDL = (L11 - DLraw) * mmask
    dDU = (U11t - DUraw) * mmask
    if rbp:
        return dDL, (PL - BLraw) * bm, dDU, (PU - BUraw) * bm
    empty = DLraw.new_zeros((B, 0, cp))
    return dDL, empty, dDU, empty


def _lu_deltas_blocks(DLraw, DUraw, BLraw, BUraw, widths, nbelow, cp: int,
                      rbp: int, mode: str = "blocked"):
    """LU panel deltas of task-major blocks, routed as
    ``_chol_deltas_blocks`` (with lu=True). Returns (dDL, dBL, dDU, dBU),
    the order of ``_lu_deltas_blocked``; the kernels return (ddl, ddu, dbl,
    dbu)."""
    B = widths.shape[0]
    r = route.route_panel(cp, rbp, B, DLraw.element_size(), lu=True,
                          mode=mode, cplx=DLraw.is_complex())
    if r == "lanes":
        ddl, ddu, dbl, dbu = panel_lanes.lu_panel_deltas_lanes(
            widths, nbelow, *(to_lanes(t) for t in (DLraw, DUraw, BLraw,
                                                  BUraw)), cp, rbp)
        return tuple(to_task_major(t) for t in (ddl, dbl, ddu, dbu))
    if r == "wide":
        ddl, ddu, dbl, dbu = panel_wide.lu_panel_deltas_wide(
            widths, nbelow, *(t.contiguous() for t in (DLraw, DUraw, BLraw,
                                                       BUraw)), cp, rbp)
        return ddl, dbl, ddu, dbu
    return _lu_deltas_blocked(DLraw, DUraw, BLraw, BUraw, widths, nbelow,
                              cp, rbp)


def factor_panels_lu_u(Lx, Ux, widths, nbelow, slab_lo: int, cp: int,
                       rbp: int, mode: str = "blocked", out=None):
    """Factor one uniform LU panel bucket IN PLACE on the same block of Lx
    and Ux (see factor_panels_chol_u; ``out`` a pair of flat arrays)."""
    B = widths.shape[0]
    bl, bu = (_panel_block(F, slab_lo, B, cp, rbp) for F in (Lx, Ux))
    dDL, dBL, dDU, dBU = _lu_deltas_blocks(
        bl[:, :cp, :], bu[:, :cp, :], bl[:, cp:, :], bu[:, cp:, :],
        widths, nbelow, cp, rbp, mode)
    tx, tu = out or (Lx, Ux)
    bl, bu = (_panel_block(F, slab_lo, B, cp, rbp) for F in (tx, tu))
    bl[:, :cp, :] += dDL
    bu[:, :cp, :] += dDU
    if rbp:
        bl[:, cp:, :] += dBL
        bu[:, cp:, :] += dBU
    return tx, tu


# --------------------------------------------------------------------------
# Supernodal triangular solves, batched per level
# --------------------------------------------------------------------------

def _x_idx(x, g):
    """Rows of x for the global indices ``g``; -1 reads and writes the
    sentinel row n of x (n + 1, nrhs)."""
    return torch.where(g >= 0, g, x.shape[0] - 1).long()


def _panel_parts_c(L, widths, nbelow, diag_start, below_start, cp: int,
                   rbp: int):
    """(L11 (B, cp, cp), L21 (B, rbp, cp)) of one uniform panel bucket,
    masked to the live widths and rows; the dead columns of L11 carry a
    unit diagonal, so the solves leave their rows of x alone."""
    cm = _col_mask(widths, cp, L.dtype)
    L11 = _task_gather(L, diag_start, cp, cp) * cm[:, None, :] \
        * _row_mask(widths, cp, L.dtype)[:, :, None] \
        + torch.diag_embed(1.0 - cm)
    if rbp:
        L21 = _task_gather(L, below_start, rbp, cp) * cm[:, None, :] \
            * _row_mask(nbelow, rbp, L.dtype)[:, :, None]
    else:
        L21 = L.new_zeros((widths.shape[0], 0, cp))
    return L11, L21


def _panel_parts(L, widths, diag_row_start, below_row_start):
    """(L11, L21) of one rowwin P bucket: the row windows, masked to the
    live widths (dead rows read zeros); dead columns of L11 carry a unit
    diagonal."""
    cp = diag_row_start.shape[1]
    cm = _col_mask(widths, cp, L.dtype)
    L11 = _win_gather(L, diag_row_start, cp) * cm[:, None, :] \
        + torch.diag_embed(1.0 - cm)
    return L11, _win_gather(L, below_row_start, cp) * cm[:, None, :]


def _solve_fwd(L11, L21, x, xcols, xrows, lu: bool):
    """x[cols] = L11^{-1} x[cols]; x[below] -= L21 x[cols], in place.
    Several tasks may carry into one row below, so the subtraction is an
    ``index_add_``."""
    ic = _x_idx(x, xcols)
    y = torch.linalg.solve_triangular(L11, x[ic], upper=False,
                                      unitriangular=lu)
    x[ic] = y
    if L21.shape[1]:
        upd = matmul.bmm(L21, y)
        x.index_add_(0, _x_idx(x, xrows).reshape(-1),
                     upd.reshape(-1, x.shape[1]), alpha=-1)
    return x


def _solve_bwd(L11, L21, x, xcols, xrows, lu: bool):
    """x[cols] = L11^{-H} (x[cols] - L21^H x[below]), in place; for LU
    (``lu``, F = U^T) the transposes, unconjugated."""
    tr = (lambda t: t.transpose(1, 2)) if lu else _ht
    ic = _x_idx(x, xcols)
    t = x[ic]
    if L21.shape[1]:
        t = t - matmul.bmm(tr(L21), x[_x_idx(x, xrows)])
    x[ic] = torch.linalg.solve_triangular(tr(L11), t, upper=True)
    return x


def solve_fwd_level_c(F, x, widths, nbelow, diag_start, below_start, xcols,
                      xrows, cp: int, rbp: int, lu: bool = False):
    """x[cols] = L11^{-1} x[cols]; x[below] -= L21 x[cols], for every task
    of one PC bucket, in place on x (n + 1, nrhs); returns x. L11 is unit
    for LU (``lu``)."""
    L11, L21 = _panel_parts_c(F, widths, nbelow, diag_start, below_start,
                              cp, rbp)
    return _solve_fwd(L11, L21, x, xcols, xrows, lu)


def solve_bwd_level_c(F, x, widths, nbelow, diag_start, below_start, xcols,
                      xrows, cp: int, rbp: int, lu: bool = False):
    """x[cols] = L11^{-H} (x[cols] - L21^H x[below]) for every task of one
    PC bucket, in place on x; returns x. For LU, F is U^T, so L11^T is U's
    diagonal block (not unit), and nothing is conjugated."""
    L11, L21 = _panel_parts_c(F, widths, nbelow, diag_start, below_start,
                              cp, rbp)
    return _solve_bwd(L11, L21, x, xcols, xrows, lu)


def solve_fwd_level(F, x, widths, diag_row_start, below_row_start, xcols,
                    xrows, lu: bool = False):
    """``solve_fwd_level_c`` for one rowwin P bucket (JAX's
    ``solve_fwd_level``; with ``lu``, unit L: ``solve_fwd_level_lu``)."""
    L11, L21 = _panel_parts(F, widths, diag_row_start, below_row_start)
    return _solve_fwd(L11, L21, x, xcols, xrows, lu)


def solve_bwd_level(F, x, widths, diag_row_start, below_row_start, xcols,
                    xrows, lu: bool = False):
    """``solve_bwd_level_c`` for one rowwin P bucket (JAX's
    ``solve_bwd_level``; for LU, F is U^T: ``solve_bwd_level_lu``). With
    ``lu`` nothing is conjugated; U's diagonal block is not unit either
    way."""
    L11, L21 = _panel_parts(F, widths, diag_row_start, below_row_start)
    return _solve_bwd(L11, L21, x, xcols, xrows, lu)
