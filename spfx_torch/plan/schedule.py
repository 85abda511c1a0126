"""Static factorization schedule: the TPU replacement for the reference's
dynamic runtime scheduling.

What the reference does at runtime, spfx does at plan time:
- leaf queue / topological task scheduling (Cholesky/Source/
  SparseFrame.c:2300-2306, 2962-2986)      -> etree *levels*: all supernodes
  of one level are independent and run as one batched kernel invocation.
- per-update (n,m,k) score triage between CPU and GPU (parameter.h:58-103)
  -> shape *buckets*: tasks padded to power-of-two classes, each class one
  batched MXU kernel with a fixed power-of-two batch quantum.
- createMap/createRelativeMap scatter maps (cuda_kernel.cu:22-60)
  -> precomputed row-start vectors: panels are stored ROW-MAJOR so every
  gather/scatter is a contiguous window per panel row (XLA lowers these to
  vector loads/stores, not elementwise gathers); the irregular *column*
  placement of an update is realized as a one-hot matmul on the MXU.
- the GPU slot/stage machinery (:1721-1907) -> nothing: XLA owns HBM; batch
  quanta bound the transient working set.

Storage layout: each supernode panel is a dense row-major (nsrow x Wp)
block in one flat value array, where Wp = the supernode width padded to the
power-of-2 grid: the storage stride IS the K/C shape class,
so every window is stride-aligned (and the padded tail columns hold exact
zeros). Flat position of local (r, c) is offset_s + r * Wp_s + c. The array
carries SLACK trailing zero slots so
fixed-width windows may safely overrun the last panel; out-of-pattern /
padding rows use start = -1, which FILL_OR_DROP gathers read as zeros and
scatters drop. Contributions whose target entry is outside the supernode
pattern are exactly zero by the elimination-tree fill theorem, so dropping
them is lossless.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import scipy.sparse as sp

from spfx_torch.symbolic.analyze import Symbolic
from spfx_torch.utils.config import Config, DEFAULT, pad_pow2

# trailing zero slack: every gather/scatter window (<= padded supernode
# width) must fit beyond the last panel. Windows are bounded by
# pad_pow2(max_sn_cols) <= 4096 for any sane config.
SLACK = 4096

# windowed one-hot extend-add group shape (see UpdateBucketC): G pairs per
# group, targets within a W-row slab window. One (W, G) @ (G, csp) MXU
# matmul + one contiguous W-row subtract per group.
EA_G = 512
EA_W = 512


def ea_window(srows: int) -> int:
    """Extend-add window height for a slab of ``srows`` rows (static)."""
    return min(EA_W, int(srows))


def _pad2(x: int, lo: int) -> int:
    return pad_pow2(int(x), lo) if x > 0 else 0


def _pad4(x: int, lo: int) -> int:
    """Round up to lo * 4^k — coarser shape classes mean fewer distinct
    kernels (call count is floor-bounded by #(level x class) pairs); the
    extra padding rides the MXU."""
    if x <= 0:
        return 0
    p = lo
    while p < x:
        p *= 4
    return p


def _pad_rows(x: int, lo: int, grain: int) -> int:
    """Row-count padding: pow2 up to ``grain``, then multiples of it.
    Caps the pow2 overshoot on tall panels (2336 -> 2560, not 4096) —
    the tallest panel's padded region sets the engine-wide per-step
    region size smax, so the overshoot is paid on EVERY scan step."""
    if x <= 0:
        return 0
    if x <= grain:
        return _pad2(x, lo)
    return -(-x // grain) * grain


def _to_device(cache: dict, device, arrs) -> tuple:
    """Torch copies of a bucket's index tables, cached per device."""
    import torch
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = tuple(torch.as_tensor(a, device=device) for a in arrs)
    return cache[key]


@dataclasses.dataclass
class PanelBucket:
    """A batch of same-padded-shape supernode panels at one level."""
    sns: np.ndarray            # (B,) supernode ids
    widths: np.ndarray         # (B,) true column counts (0 for pad items)
    diag_row_start: np.ndarray  # (B, Cp) int32 flat row starts, -1 invalid
    below_row_start: np.ndarray  # (B, Rbp) int32, -1 invalid
    xcols: np.ndarray          # (B, Cp) int32 global columns (solve), -1
    xrows: np.ndarray          # (B, Rbp) int32 global below rows (solve), -1
    flops: float
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)
    _dev_f: dict = dataclasses.field(default_factory=dict, repr=False)

    def to(self, device):
        return _to_device(self._dev, device, (
            self.widths, self.diag_row_start, self.below_row_start,
            self.xcols, self.xrows))

    def to_f(self, device):
        """(widths, nbelow, diag_row_start, below_row_start) on ``device``:
        the factorization step's inputs, with each task's live below-row
        count (its live below rows lead)."""
        nbelow = (self.below_row_start >= 0).sum(axis=1).astype(np.int32)
        return _to_device(self._dev_f, device, (
            self.widths, nbelow, self.diag_row_start, self.below_row_start))


@dataclasses.dataclass
class UpdateBucket:
    """A batch of same-padded-shape descendant->ancestor update tasks.

    Each task computes C = Ld[lpos:, :] @ Ld[lpos:lpos+N, :]^T, expands the
    N columns into the target's (padded) width with a one-hot matmul, and
    scatter-subtracts whole rows into the ancestor panel (ref cpuApply
    :2030-2102 / mappedSubtract cuda_kernel.cu:62-124; the atomics are gone
    because levels group writers and XLA scatter-add is deterministic).
    """
    kw: np.ndarray             # (B,) true K (descendant width), 0 pad
    src_row_start: np.ndarray  # (B, Mp) int32, -1 invalid
    tgt_row_start: np.ndarray  # (B, Mp) int32, -1 invalid/missing
    tgt_cpos: np.ndarray       # (B, Np) int32 col index in target, -1 pad
    kp: int                    # static source gather window
    csp: int                   # static target width window
    flops: float
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    def to(self, device):
        return _to_device(self._dev, device, (
            self.kw, self.src_row_start, self.tgt_row_start,
            self.tgt_cpos))


@dataclasses.dataclass
class PanelBucketC:
    """Contig-layout panel batch. Storage is uniform (see build_plan): the
    bucket's panels are one contiguous range starting at slab_lo with task
    stride (cp + rbp) * cp — diag block rows [0, cp), below block rows
    [cp, cp + rbp) — so the whole bucket is read and written with ONE
    dynamic slice (per-task windows kept for the solve path)."""
    sns: np.ndarray
    widths: np.ndarray         # (B,) true column counts (0 for pad items)
    nbelow: np.ndarray         # (B,) true below-row counts
    diag_start: np.ndarray     # (B,) int32 flat start of rows 0..cp, -1 pad
    below_start: np.ndarray    # (B,) int32 flat start of rows cp.., -1
    xcols: np.ndarray          # (B, Cp) global columns (solve), -1
    xrows: np.ndarray          # (B, Rbp) global below rows (solve), -1
    slab_lo: np.ndarray        # (1,) int32 flat start of the uniform block
    cp: int                    # static padded width == storage stride
    rbp: int                   # static padded below-row count
    flops: float
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)
    _dev_u: dict = dataclasses.field(default_factory=dict, repr=False)

    def to(self, device):
        return _to_device(self._dev, device, (
            self.widths, self.nbelow, self.diag_start, self.below_start,
            self.xcols, self.xrows))

    def to_u(self, device):
        """(widths, nbelow, slab_lo) on ``device`` — the uniform-block
        factorization path's inputs."""
        return _to_device(self._dev_u, device, (
            self.widths, self.nbelow, self.slab_lo))


@dataclasses.dataclass
class UpdateBucketC:
    """Contig-layout update batch: one contiguous (mp x kp) source window
    per task (the N block is its leading rows).

    The extend-add target is expressed as a SLAB: all tasks of a chunk
    target panels inside one contiguous storage range [slab_lo, slab_lo +
    slab_rows*csp) (storage is level-major and same-stride panels of a level
    are adjacent, see build_plan), viewed as a (slab_rows, csp) matrix.
    tgt_lrow holds each update row's SUBLANE index in that view, so the
    extend-add is a VMEM-local row loop instead of an XLA scatter (measured
    2.6us/row on TPU — the round-2 engine's dominant cost)."""
    kw: np.ndarray             # (B,) true K (descendant width), 0 pad
    mrows: np.ndarray          # (B,) true M rows
    src_start: np.ndarray      # (B,) int32 flat start of source rows, -1
    slab_lo: np.ndarray        # (1,) int32 flat start of the target slab
    tgt_lrow: np.ndarray       # (B, Mp) int32 slab row index, -1 invalid
    tgt_cpos: np.ndarray       # (B, Np) int32 col index in target, -1 pad
    mp: int                    # static source row window
    kp: int                    # static source width == source stride
    csp: int                   # static target width == target stride
    slab_rows: int             # static slab height (pow2)
    flops: float
    # WINDOWED ONE-HOT extend-add plan (round 4): the valid update rows,
    # sorted by target slab row, cut into groups of <= EA_G pairs whose
    # targets span < EA_W slab rows. Each group lands as ONE MXU matmul
    # (W x G one-hot) @ (G x csp E rows) subtracted into a contiguous
    # W-row slab window — no scatter, no serial row loop (the round-3
    # Pallas row loop measured ~1.9us/row on hardware; ~1M real rows at
    # 48^3 made it the dominant factorize cost).
    ea_idx: np.ndarray = None   # (ngroups*EA_G,) int32 flat E row, 0 pad
    ea_rbase: np.ndarray = None  # (ngroups,) int32 window base slab row
    ea_rel: np.ndarray = None   # (ngroups, EA_G) int32 row - rbase, -1 pad
    ea_ng: np.ndarray = None    # (1,) int32 TRUE group count: the mega
    #                             engine's class tables pad ngroups to the
    #                             class max, and each dead group would cost
    #                             a full (W, EA_G) x (EA_G, csp) MXU matmul
    #                             — the extend-add loop trips ea_ng times
    # M-TILED form (round 5, config.update_tile): each batch item is a tile
    # of <= mp source rows of one task; head_start points at the task's
    # leading (N-block) rows, gathered separately as a (csp, kp) window
    # (N <= width(target) <= csp always). tgt_cpos is then (B, csp).
    # head_start is None for round-4 pow4-M buckets (N block = leading rows
    # of the tile's own window).
    head_start: np.ndarray = None  # (B,) int32 flat start of task head, -1
    rstart: np.ndarray = None   # (B,) int32 row of the tile's first true
    #                             row inside its ALIGN-superwindow (the
    #                             gather DMA aligns starts down; see
    #                             _make_update_bucket_t)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    def to(self, device):
        """The step's tables on ``device``: (kw, mrows, [rstart, src_start,
        head_start | src_start], slab_lo, rows, tgt_cpos), where ``rows`` is
        tgt_lrow flattened to (B * rows,) int32: the slab row of every row
        of the step's E, -1 where the row is dropped (the extend-add
        kernel's row table). The ea_* group tables stay on the host."""
        rows = np.ascontiguousarray(self.tgt_lrow.reshape(-1),
                                    dtype=np.int32)
        arrs = (self.kw, self.mrows, self.src_start, self.slab_lo, rows,
                self.tgt_cpos)
        if self.head_start is not None:
            arrs = arrs[:2] + (self.rstart, self.src_start,
                               self.head_start) + arrs[3:]
        return _to_device(self._dev, device, arrs)

    @property
    def tgt_row_start(self) -> np.ndarray:
        """Flat row starts (compat view for scatter-based engines, e.g. the
        sharded delta accumulation in spfx.dist.factorize)."""
        return np.where(
            self.tgt_lrow >= 0,
            int(self.slab_lo[0]) + self.tgt_lrow.astype(np.int64) * self.csp,
            -1).astype(np.int32)


@dataclasses.dataclass
class LevelPlan:
    panels: List[PanelBucket]
    updates: List[UpdateBucket]


@dataclasses.dataclass
class FactorPlan:
    n: int
    xsize: int
    levels: List[LevelPlan]
    assembly_idx: np.ndarray   # flat L position per permuted-lower-A entry
    offsets: np.ndarray        # (nsuper,) panel offsets
    flops: float
    assembly_idx_u: np.ndarray | None = None  # LU: U^T panel positions for
    #                                           strict-upper A entries
    strides: np.ndarray | None = None  # (nsuper,) padded panel widths Wp
    slack: int = SLACK              # trailing zero slots >= max task window
    below_shift: np.ndarray | None = None  # (nsuper,) storage-row shift of
    #                                        below rows (uniform layout);
    #                                        zeros for rowwin
    rows_sn: np.ndarray | None = None  # (nsuper,) padded storage rows per
    #                                    panel (uniform layout): the layout
    #                                    of record for engines that size
    #                                    per-panel extents (spfx.stream)

    @property
    def storage(self) -> int:
        return self.xsize + self.slack


def _batch_quantum(total: int, per_item_elems: int, budget: int,
                   floor: int = 1 << 18, max_pad_ratio: float = 0.0) -> int:
    """Power-of-two chunk size for a shape class: floored so tiny classes
    share a signature (and each call carries enough work to amortize launch
    overhead), capped so one chunk's working set stays under ``budget``
    elements, never more than the padded class population.

    max_pad_ratio > 0 additionally caps the quantum at
    pad_pow2(ratio * total): bounds dead padded work per call at the cost of
    more distinct (shape, batch) jit signatures across levels."""
    per = max(1, per_item_elems)
    qcap = 1 << (max(1, budget // per).bit_length() - 1)
    qmin = min(qcap, pad_pow2(max(1, floor // per), 1))
    if max_pad_ratio > 0:
        qmin = min(qmin, pad_pow2(max(1, int(max_pad_ratio * total)), 1))
    return min(max(pad_pow2(total, 1), qmin), qcap)


def _row_position_lookup(sym: Symbolic):
    """Vectorised (supernode, global row) -> local pattern row index, or -1.

    Encodes pattern membership as strictly increasing keys s*(n+1)+row over
    the concatenated patterns, then one searchsorted answers all queries.
    """
    n = sym.n
    R = np.diff(sym.sn_ptr)
    row_sn = np.repeat(np.arange(sym.nsuper, dtype=np.int64), R)
    hay = row_sn * (n + 1) + sym.sn_rows

    def rowpos(s_arr, i_arr):
        q = s_arr.astype(np.int64) * (n + 1) + i_arr
        p = np.searchsorted(hay, q)
        pc = np.minimum(p, len(hay) - 1)
        valid = hay[pc] == q
        local = pc - sym.sn_ptr[s_arr]
        return np.where(valid, local, -1)

    return rowpos


def build_plan(sym: Symbolic, A: sp.spmatrix, config: Config = DEFAULT,
               lu: bool = False,
               sn_filter: np.ndarray | None = None,
               sn_group: np.ndarray | None = None,
               idx_dtype=np.int32) -> FactorPlan:
    """Compile the symbolic factorization + matrix pattern into the static
    batched schedule (the TPU-era analyze_supernodal stages e-h).

    ``sn_filter`` (bool, nsuper): restrict the schedule to panel tasks of
    the selected supernodes and update tasks SOURCED at them (targets may
    lie anywhere above). Storage layout, assembly and slab shapes are
    always computed from the full symbolic structure, so filtered plans
    from disjoint filters share one storage layout — the basis of the
    subtree-decomposed multi-chip engine (spfx.dist.subtree).

    ``sn_group`` (int, nsuper): extra storage-sort key inside each
    (level, stride) class, so each group's panels stay CONTIGUOUS in the
    uniform layout (a filtered plan's panel buckets must be uniform
    blocks). Pass the same grouping to every plan sharing the layout.

    ``idx_dtype``: dtype of the bucket index tables. int32 is the device
    default (and enforces the 2^31-element storage ceiling); the stage
    streaming engine (spfx.stream) builds int64 plans and rebases each
    stage's tables to int32 itself."""
    n = sym.n
    nsuper = sym.nsuper
    contig = config.layout == "contig"
    W = np.diff(sym.sn_start).astype(np.int64)
    R = np.diff(sym.sn_ptr).astype(np.int64)
    lo = config.pad_min
    if contig:
        # stride floor collapses tiny source-stride (kp) update classes;
        # the padded tail columns hold exact zeros like any other padding
        smin = max(lo, int(getattr(config, "stride_min", 0) or 0))
        Wp = np.asarray([max(_pad2(int(w), lo), smin) for w in W],
                        dtype=np.int64)
    elif config.stride_padding:
        Wp = np.asarray([_pad2(int(w), lo) for w in W], dtype=np.int64)
    else:
        Wp = W.copy()     # stride == true width; windows overlap row tails
    offsets = np.zeros(nsuper, dtype=np.int64)
    clo = max(lo, config.class_min)
    if contig:
        # LEVEL-MAJOR UNIFORM storage: panels ordered by (level, stride,
        # padded-below-rows, id) and padded to exactly (Wp + RBp) rows, so
        # every (level, cp, rbp) panel bucket is ONE contiguous range with
        # uniform task stride — read/written with a single dynamic_slice
        # instead of per-task gathers (~1.2us) and scatters (~2.6us each,
        # measured on TPU), and a level's same-stride panels — the targets
        # of its update chunks — likewise form the contiguous slab the
        # extend-add kernel needs (the reference's stage-local buffer
        # offsets idea, Cholesky/Source/SparseFrame.c:1875-1907, re-aimed
        # at VMEM). Diag block lives at rows [0, cp), below block at rows
        # [cp, cp + nb); rows [w, cp) and [cp + nb, cp + rbp) are zero
        # padding.
        grain = max(clo, int(getattr(config, "row_grain", 512) or 512))
        RBp = np.asarray([_pad_rows(int(b), clo, grain) for b in R - W],
                         dtype=np.int64)
        rows_sn = Wp + RBp
        grp = sn_group if sn_group is not None \
            else np.zeros(nsuper, dtype=np.int64)
        sorder = np.lexsort((np.arange(nsuper), grp, RBp, Wp,
                             sym.sn_level))
        csum = np.zeros(nsuper + 1, dtype=np.int64)
        np.cumsum((rows_sn * Wp)[sorder], out=csum[1:])
        offsets[sorder] = csum[:-1]
        below_shift = Wp - W            # storage row = p + shift for p >= w
    else:
        np.cumsum(R[:-1] * Wp[:-1], out=offsets[1:])
        rows_sn = R
        RBp = None
        below_shift = np.zeros(nsuper, dtype=np.int64)
    xsize = int((rows_sn * Wp).sum())
    if xsize + SLACK >= 2**31 and idx_dtype == np.int32:
        raise ValueError(
            f"factor too large for int32 indexing: {xsize} "
            "(use spfx.stream.StreamingCholesky for out-of-core plans)")
    first_col = sym.sn_start[:-1]
    rowpos = _row_position_lookup(sym)
    slack = SLACK
    region_max = 0          # largest single-step writable region (elements)

    def smap(s_arr, p_arr):
        """Pattern row index -> storage row index (vectorized)."""
        return p_arr + np.where(p_arr >= W[s_arr], below_shift[s_arr], 0)

    # ---------------- panel buckets per level ---------------------------
    nlev = int(sym.sn_level.max()) + 1 if nsuper else 0
    levels = [LevelPlan([], []) for _ in range(nlev)]
    order = np.argsort(sym.sn_level, kind="stable")
    lvl_sorted = sym.sn_level[order]
    total_flops = 0.0
    padf = _pad4 if config.class_granularity == "pow4" else _pad2
    for lv in range(nlev):
        sns = order[np.searchsorted(lvl_sorted, lv):
                    np.searchsorted(lvl_sorted, lv, side="right")]
        if sn_filter is not None:
            sns = sns[sn_filter[sns]]
        w, r = W[sns], R[sns]
        if contig:
            # class = (storage stride, padded below rows) — the per-panel
            # storage pad (rows_sn) uses the same key, so a class's panels
            # are contiguous AND uniformly strided in storage
            pkeys = np.stack([Wp[sns], RBp[sns]], axis=1) \
                if len(sns) else np.zeros((0, 2), np.int64)
        else:
            pkeys = np.stack([[_pad2(int(a), clo), _pad2(int(b), clo)]
                              for a, b in zip(Wp[sns], r - w)]) \
                if len(sns) else np.zeros((0, 2), np.int64)
        for key in (np.unique(pkeys, axis=0) if len(sns) else []):
            cp, rbp = int(key[0]), int(key[1])
            sel = sns[(pkeys[:, 0] == cp) & (pkeys[:, 1] == rbp)]
            if contig:
                sel = sel[np.argsort(offsets[sel], kind="stable")]
            qb = _batch_quantum(len(sel), (cp + rbp) * cp,
                                min(config.max_gather_elems,
                                    config.max_region_elems),
                                config.batch_floor_elems,
                                config.max_pad_ratio)
            slack = max(slack, (cp + rbp) * cp)
            region_max = max(region_max, qb * (cp + rbp) * cp)
            for c0 in range(0, len(sel), qb):
                mk = _make_panel_bucket_c if contig else _make_panel_bucket
                pb = mk(sel[c0:c0 + qb], W, Wp, R, offsets,
                        first_col, sym, cp, rbp, qb,
                        **({"idx_dtype": idx_dtype} if contig else {}))
                levels[lv].panels.append(pb)
                total_flops += pb.flops
                if contig:
                    # padded batch tail of the uniform block may overrun
                    # storage: grow trailing slack to cover it
                    need = int(offsets[sel[c0]]) \
                        + qb * (cp + rbp) * cp - xsize
                    if need > slack:
                        slack = need

    # ---------------- update tasks --------------------------------------
    m = len(sym.sn_rows)
    row_sn = np.repeat(np.arange(nsuper, dtype=np.int64), R)
    loc = np.arange(m, dtype=np.int64) - sym.sn_ptr[row_sn]
    isbelow = loc >= W[row_sn]
    d_ent = row_sn[isbelow]
    i_ent = sym.sn_rows[isbelow]
    lpos_ent = loc[isbelow]
    if len(d_ent):
        owner = sym.sn_of[i_ent]
        key = d_ent * nsuper + owner
        starts = np.flatnonzero(np.diff(key, prepend=key[0] - 1))
        t_d = d_ent[starts]
        t_s = owner[starts]
        t_lpos = lpos_ent[starts]
        t_N = np.diff(np.append(starts, len(d_ent)))
        t_M = R[t_d] - t_lpos
        t_K = W[t_d]
        # schedule each update at its TARGET's level (left-looking apply,
        # ref cpuApply drains the pending-update list right before the panel
        # factors, :2123-2132): sources from many levels consolidate into
        # the same shape class, so batches are fatter and calls fewer. The
        # numeric engines run a level's updates BEFORE its panel factors.
        t_level = sym.sn_level[t_s]
        # column windowing: an update touches only target columns
        # [cmin, cmax] (pattern rows are sorted, so the span is just the
        # first/last source row's position in the target). Expanding and
        # scattering only that span — shifted row starts + span-relative
        # one-hot — cuts the one-hot matmul and the scatter-add traffic by
        # the span/width ratio (measured 4x less scatter traffic on 3D
        # Poisson 48^3). Tail overrun past the row is safe: the one-hot
        # leaves columns beyond the true span exactly zero, and adding
        # zeros is a no-op (same invariant the padded tails already use).
        t_cmin = sym.sn_rows[sym.sn_ptr[t_d] + t_lpos] - first_col[t_s]
        t_cmax = sym.sn_rows[sym.sn_ptr[t_d] + t_lpos + t_N - 1] \
            - first_col[t_s]
        t_span = t_cmax - t_cmin + 1
        clo = max(lo, config.class_min)
        if contig or config.stride_padding:
            kcls = list(Wp[t_d])        # K class == source storage stride
            ccls = list(Wp[t_s])        # Csp class == target storage stride
            t_cmin = np.zeros_like(t_cmin)
        elif config.update_windowing:
            kcls = [padf(a, clo) for a in t_K]
            ccls = [padf(a, clo) for a in t_span]
        else:
            kcls = [padf(a, clo) for a in t_K]
            ccls = [padf(a, clo) for a in W[t_s]]
            t_cmin = np.zeros_like(t_cmin)
        t_pad = np.stack([
            [padf(a, clo) for a in t_M],
            [padf(a, clo) for a in t_N],
            kcls, ccls], axis=1)
        # slab working-set cap: the extend-add kernel keeps the whole slab
        # VMEM-resident, so its PADDED bytes (lane dim rounds up to 128 —
        # see spfx.kernels.vmem) must fit comfortably. slab_rows is a
        # PER-STRIDE constant (grown to fit the largest single panel of
        # that stride — such oversized slabs fall back to XLA scatter in
        # extend_add_rows): if it varied per (level, class), every level
        # would mint its own switch class and compile time would blow back
        # up (measured 114 -> 269 classes at 48^3).
        slab_bytes = 1 << 21
        itemsize = np.dtype(config.dtype).itemsize
        srows_by_csp = {}
        if contig:
            grain = max(clo, int(getattr(config, "row_grain", 512) or 512))
            for c in np.unique(Wp):
                big = int(rows_sn[Wp == c].max())
                lane_bytes = max(128, int(c)) * itemsize
                srows_by_csp[int(c)] = _pad_rows(
                    max(slab_bytes // lane_bytes, big), 8, grain)
        keep_upd = sn_filter[t_d] if sn_filter is not None \
            else np.ones(len(t_d), dtype=bool)
        # ---- M-TILED update classes (round 5, config.update_tile) -------
        # Cut every task's source rows into tiles of <= update_tile rows
        # (short tasks form an update_small class), so the class key is
        # (mp in {small, tile}, kp, csp) — the pow4 M ladder disappears and
        # the (level x class) pair count (the scan's step-count floor)
        # drops ~1.75x at 48^3. The task's N block (leading N source rows,
        # N <= target width <= csp) is gathered separately per tile via
        # head_start.
        tiled = contig and int(getattr(config, "update_tile", 0) or 0) > 0
        if tiled and len(d_ent):
            TL = int(config.update_tile)
            TS = max(8, min(int(config.update_small or TL), TL))
            mp_task = np.where(t_M <= TS, TS, TL).astype(np.int64)
            ntile = np.where(t_M > TL, -(-t_M // TL), 1).astype(np.int64)
            tcsum = np.concatenate([[0], np.cumsum(ntile)])
            tid = np.repeat(np.arange(len(t_d), dtype=np.int64), ntile)
            tix = np.arange(tcsum[-1], dtype=np.int64) - tcsum[tid]
            u_lpos = t_lpos[tid] + tix * TL
            u_M = np.minimum(t_M[tid] - tix * TL, mp_task[tid])
            keys_all = np.stack([mp_task[tid], Wp[t_d[tid]],
                                 Wp[t_s[tid]]], axis=1)
            for lv in range(nlev):
                in_lv = np.flatnonzero((t_level[tid] == lv)
                                       & keep_upd[tid])
                if not len(in_lv):
                    continue
                keys = keys_all[in_lv]
                for key in np.unique(keys, axis=0):
                    mp, kp, csp = (int(x) for x in key)
                    sel = in_lv[(keys == key).all(axis=1)]
                    ext = ALIGN // kp          # superwindow slack rows
                    qb = _batch_quantum(
                        len(sel), (mp + ext) * kp + (csp + ext) * kp
                        + 2 * (mp + ext) * csp,
                        config.max_gather_elems, config.batch_floor_elems,
                        config.max_pad_ratio)
                    slack = max(slack, (mp + ext) * kp, (csp + ext) * kp)
                    sel = sel[np.argsort(offsets[t_s[tid[sel]]],
                                         kind="stable")]
                    t_off = offsets[t_s[tid[sel]]]
                    t_end = t_off + rows_sn[t_s[tid[sel]]] \
                        * Wp[t_s[tid[sel]]]
                    srows = srows_by_csp[csp]
                    cap = srows * csp
                    region_max = max(region_max, cap)
                    chunks = []
                    i0 = 0
                    for i in range(1, len(sel)):
                        if i - i0 >= qb or t_end[i] - t_off[i0] > cap:
                            chunks.append((i0, i))
                            i0 = i
                    chunks.append((i0, len(sel)))
                    for a, b in chunks:
                        ub = _make_update_bucket_t(
                            sel[a:b], tid, t_d, t_s, t_lpos, t_N, t_K,
                            u_lpos, u_M, Wp, offsets, first_col, sym,
                            rowpos, mp, kp, csp, qb, srows, W,
                            below_shift, idx_dtype)
                        levels[lv].updates.append(ub)
                        total_flops += ub.flops
                        need = int(ub.slab_lo[0]) + srows * csp - xsize
                        if need > slack:
                            slack = need
        for lv in range(nlev) if not tiled else ():
            in_lv = np.flatnonzero((t_level == lv) & keep_upd)
            if not len(in_lv):
                continue
            pads = t_pad[in_lv]
            for key in np.unique(pads, axis=0):
                mp, np_, kp, csp = (int(x) for x in key)
                sel = in_lv[(pads == key).all(axis=1)]
                qb = _batch_quantum(
                    len(sel), mp * kp + mp * np_ + (mp + np_) * csp,
                    config.max_gather_elems, config.batch_floor_elems,
                    config.max_pad_ratio)
                slack = max(slack, mp * kp)
                if not contig:
                    for c0 in range(0, len(sel), qb):
                        ub = _make_update_bucket(
                            sel[c0:c0 + qb], t_d, t_s, t_lpos, t_M, t_N,
                            t_K, Wp, R, offsets, first_col, sym, rowpos,
                            mp, np_, kp, csp, qb, t_cmin)
                        levels[lv].updates.append(ub)
                        total_flops += ub.flops
                    continue
                # contig: order tasks by target panel offset and cut chunks
                # so each chunk's targets fit one slab of srows rows
                sel = sel[np.argsort(offsets[t_s[sel]], kind="stable")]
                t_off = offsets[t_s[sel]]
                t_end = t_off + rows_sn[t_s[sel]] * Wp[t_s[sel]]
                srows = srows_by_csp[csp]
                cap = srows * csp
                region_max = max(region_max, cap)
                chunks = []
                i0 = 0
                for i in range(1, len(sel)):
                    if i - i0 >= qb or t_end[i] - t_off[i0] > cap:
                        chunks.append((i0, i))
                        i0 = i
                chunks.append((i0, len(sel)))
                for a, b in chunks:
                    ub = _make_update_bucket_c(
                        sel[a:b], t_d, t_s, t_lpos, t_M, t_N, t_K,
                        Wp, R, offsets, first_col, sym, rowpos,
                        mp, np_, kp, csp, qb, srows, W, below_shift,
                        idx_dtype)
                    levels[lv].updates.append(ub)
                    total_flops += ub.flops
                    # the padded slab [lo, lo+srows*csp) must stay inside
                    # storage: grow the trailing slack to cover the overrun
                    need = int(ub.slab_lo[0]) + srows * csp - xsize
                    if need > slack:
                        slack = need

    # ---------------- assembly scatter (ref loadA :1998-2028) ------------
    def entry_positions(M_: sp.csc_matrix) -> np.ndarray:
        arow = M_.indices.astype(np.int64)
        acol = np.repeat(np.arange(n, dtype=np.int64), np.diff(M_.indptr))
        s_of = sym.sn_of[acol]
        lpos = rowpos(s_of, arow)
        if (lpos < 0).any():
            raise AssertionError("A entry outside factor pattern")
        return offsets[s_of] + smap(s_of, lpos) * Wp[s_of] \
            + (acol - first_col[s_of])

    Ap = sp.csc_matrix(A)[sym.perm][:, sym.perm]
    assembly_idx = entry_positions(sp.tril(Ap).tocsc())
    assembly_idx_u = None
    if lu:
        # strict-upper entry (i,j), i<j, lives in the U^T panel of the
        # supernode owning column i, at (rowpos(j), i - c1) — the lower-
        # triangle position map applied to Ap^T
        # (ref LU loadA, LU/Source/SparseFrame.c:2478-2536).
        assembly_idx_u = entry_positions(sp.tril(Ap.T, -1).tocsc())

    # region-return engine contract: any step's region window
    # [base, base + region_max) must stay inside storage for every base
    slack = max(slack, region_max)
    if xsize + slack >= 2**31 and idx_dtype == np.int32:
        raise ValueError(
            f"factor too large for int32 indexing: {xsize} "
            "(use spfx.stream.StreamingCholesky for out-of-core plans)")
    return FactorPlan(n=n, xsize=xsize, levels=levels,
                      assembly_idx=assembly_idx, offsets=offsets,
                      flops=(2.0 if lu else 1.0) * total_flops,
                      assembly_idx_u=assembly_idx_u, strides=Wp,
                      slack=slack, below_shift=below_shift,
                      rows_sn=np.asarray(rows_sn, dtype=np.int64))


def plan_stats(plan: FactorPlan) -> dict:
    """Schedule-shape counters for one plan — the numbers that steer the
    padding vs dispatch trade-off (the TPU-era analogue of the reference's
    PRINT_DEBUG GPU cache-hit counters, Cholesky/Source/SparseFrame.c:
    3012-3013). Printed by the engines under Config.profile."""
    classes = {}
    steps = upd_steps = pan_steps = 0
    true_fl = padded_fl = 0.0
    tasks = dead = 0
    region_max = gather = 0
    for lp in plan.levels:
        for ub in lp.updates:
            steps += 1
            upd_steps += 1
            B = len(ub.kw)
            tasks += B
            dead += int((np.asarray(ub.kw) == 0).sum())
            true_fl += ub.flops
            if isinstance(ub, UpdateBucketC):
                np_ = ub.tgt_cpos.shape[1]
                key = ("UT" if ub.head_start is not None else "UC",
                       ub.mp, ub.kp, ub.csp, ub.slab_rows)
                padded_fl += 2.0 * B * ub.mp * np_ * (ub.kp + ub.csp)
                gather += B * (ub.mp * ub.kp
                               + (ub.csp * ub.kp
                                  if ub.head_start is not None else 0))
                region_max = max(region_max, ub.slab_rows * ub.csp)
            else:
                np_ = ub.tgt_cpos.shape[1]
                mp = ub.src_row_start.shape[1]
                key = ("U", mp, ub.kp, ub.csp)
                padded_fl += 2.0 * B * mp * np_ * (ub.kp + ub.csp)
                gather += B * mp * ub.kp
            classes[key] = classes.get(key, 0) + 1
        for pb in lp.panels:
            steps += 1
            pan_steps += 1
            B = len(pb.widths)
            tasks += B
            dead += int((np.asarray(pb.widths) == 0).sum())
            true_fl += pb.flops
            if isinstance(pb, PanelBucketC):
                key = ("PC", pb.cp, pb.rbp)
                padded_fl += B * (pb.cp ** 3 / 3.0 + pb.rbp * pb.cp ** 2)
                region_max = max(region_max,
                                 B * (pb.cp + pb.rbp) * pb.cp)
            else:
                cp = pb.diag_row_start.shape[1]
                rbp = pb.below_row_start.shape[1]
                key = ("P", cp, rbp)
                padded_fl += B * (cp ** 3 / 3.0 + rbp * cp ** 2)
            classes[key] = classes.get(key, 0) + 1
    return {
        "steps": steps, "update_steps": upd_steps,
        "panel_steps": pan_steps, "levels": len(plan.levels),
        "classes": len(classes),
        "tasks": tasks,
        "dead_task_frac": round(dead / max(tasks, 1), 4),
        "true_gflops": round(true_fl / 1e9, 3),
        "padded_gflops": round(padded_fl / 1e9, 3),
        "padded_flop_ratio": round(padded_fl / max(true_fl, 1.0), 2),
        "gather_mb": round(gather * 4 / 1e6, 1),
        "region_max_mb": round(region_max * 4 / 1e6, 2),
        "storage_mb": round(plan.storage * 4 / 1e6, 1),
        "step_region_traffic_gb": round(
            steps * region_max * 2 * 4 / 1e9, 2),
        "class_census": sorted(classes.items(),
                               key=lambda kv: -kv[1])[:12],
    }


def _pad_batch(arrs, B, Bq, fills):
    if Bq == B:
        return arrs
    return [np.concatenate(
        [a, np.full((Bq - B,) + a.shape[1:], f, dtype=a.dtype)])
        for a, f in zip(arrs, fills)]


def _make_panel_bucket(sel, W, Wp, R, offsets, first_col, sym, cp, rbp,
                       qb=None):
    B = len(sel)
    qb = pad_pow2(B, 1) if qb is None else qb
    w, wp, r, off = W[sel], Wp[sel], R[sel], offsets[sel]
    ci = np.arange(cp, dtype=np.int64)[None, :]
    vc = ci < w[:, None]
    diag_row_start = np.where(vc, off[:, None] + ci * wp[:, None], -1)
    ri = np.arange(rbp, dtype=np.int64)[None, :]
    vr = ri < (r - w)[:, None]
    below_row_start = np.where(vr, off[:, None] + (w[:, None] + ri)
                               * wp[:, None], -1)
    xcols = np.where(vc, first_col[sel][:, None] + ci, -1)
    if rbp:
        pat_idx = np.minimum(sym.sn_ptr[sel][:, None] + w[:, None] + ri,
                             len(sym.sn_rows) - 1)
        xrows = np.where(vr, sym.sn_rows[pat_idx], -1)
    else:
        xrows = np.zeros((B, 0), np.int64)
    flops = float((w.astype(float)**3 / 3.0
                   + (r - w).astype(float) * w.astype(float)**2).sum())
    i32 = np.int32
    arrs = _pad_batch([w, diag_row_start, below_row_start, xcols, xrows],
                      B, qb, [0, -1, -1, -1, -1])
    return PanelBucket(sel, *(a.astype(i32) for a in arrs), flops)


def _make_panel_bucket_c(sel, W, Wp, R, offsets, first_col, sym, cp, rbp,
                         qb=None, idx_dtype=np.int32):
    """Contig-layout panel bucket over a UNIFORM storage block: panels of
    ``sel`` are contiguous with task stride (cp+rbp)*cp (asserted)."""
    B = len(sel)
    qb = pad_pow2(B, 1) if qb is None else qb
    w, r, off = W[sel], R[sel], offsets[sel]
    nb = r - w
    stride = (cp + rbp) * cp
    assert (np.diff(off) == stride).all(), "panel bucket not uniform"
    diag_start = off
    below_start = off + cp * cp            # below block at rows [cp, ...)
    ci = np.arange(cp, dtype=np.int64)[None, :]
    vc = ci < w[:, None]
    xcols = np.where(vc, first_col[sel][:, None] + ci, -1)
    if rbp:
        ri = np.arange(rbp, dtype=np.int64)[None, :]
        vr = ri < nb[:, None]
        pat_idx = np.minimum(sym.sn_ptr[sel][:, None] + w[:, None] + ri,
                             len(sym.sn_rows) - 1)
        xrows = np.where(vr, sym.sn_rows[pat_idx], -1)
    else:
        xrows = np.zeros((B, 0), np.int64)
    flops = float((w.astype(float)**3 / 3.0
                   + nb.astype(float) * w.astype(float)**2).sum())
    arrs = _pad_batch([w, nb, diag_start, below_start, xcols, xrows],
                      B, qb, [0, 0, -1, -1, -1, -1])
    return PanelBucketC(sel, *(a.astype(idx_dtype) for a in arrs),
                        np.asarray([off[0]], idx_dtype), cp, rbp, flops)


def _make_update_bucket_c(sel, t_d, t_s, t_lpos, t_M, t_N, t_K,
                          Wp, R, offsets, first_col, sym, rowpos,
                          mp, np_, kp, csp, qb, srows, W, bshift,
                          idx_dtype=np.int32):
    """Contig-layout update bucket: one (mp x kp) source window per task
    (requires kp == Wp[d], csp == Wp[s]); slab extend-add target (tasks are
    pre-sorted by target offset, all inside [slab_lo, slab_lo+srows*csp))."""
    B = len(sel)
    d, s = t_d[sel], t_s[sel]
    lpos, M, N = t_lpos[sel], t_M[sel], t_N[sel]
    # source rows are strictly below the descendant's diag block, which in
    # uniform storage sits at rows [cp_d, cp_d + nb): shift by Wp[d] - W[d]
    src_start = offsets[d] + (lpos + bshift[d]) * Wp[d]
    slab_lo = int(offsets[s[0]])
    mi = np.arange(mp, dtype=np.int64)[None, :]
    vm = mi < M[:, None]
    pat = np.minimum(sym.sn_ptr[d][:, None] + lpos[:, None] + mi,
                     len(sym.sn_rows) - 1)
    grow = sym.sn_rows[pat]
    tpos = rowpos(np.broadcast_to(s[:, None], grow.shape).ravel(),
                  grow.ravel()).reshape(grow.shape)
    # target storage row: diag rows stay, below rows shift past the padding
    spos = tpos + np.where(tpos >= W[s][:, None], bshift[s][:, None], 0)
    base_row = (offsets[s] - slab_lo) // csp                # panel row base
    tgt_lrow = np.where(vm & (tpos >= 0),
                        base_row[:, None] + spos, -1)
    ni = np.arange(np_, dtype=np.int64)[None, :]
    vn = ni < N[:, None]
    patn = np.minimum(sym.sn_ptr[d][:, None] + lpos[:, None] + ni,
                      len(sym.sn_rows) - 1)
    q = sym.sn_rows[patn]
    tgt_cpos = np.where(vn, q - first_col[s][:, None], -1)
    flops = float(2.0 * (M.astype(float) * N * t_K[sel]).sum())
    arrs = _pad_batch([t_K[sel], M, src_start, tgt_lrow, tgt_cpos],
                      B, qb, [0, 0, -1, -1, -1])
    kw_a, m_a, ss_a, lr_a, cp_a = (a.astype(idx_dtype) for a in arrs)
    ea_idx, ea_rbase, ea_rel = _ea_group_tables(lr_a, srows)
    sds = _pad_batch([d], B, qb, [-1])[0].astype(np.int64)
    ub = UpdateBucketC(kw_a, m_a, ss_a,
                       np.asarray([slab_lo], idx_dtype), lr_a, cp_a,
                       mp, kp, csp, int(srows), flops,
                       ea_idx=ea_idx, ea_rbase=ea_rbase, ea_rel=ea_rel,
                       ea_ng=np.asarray([len(ea_rbase)], np.int32))
    ub.sds = sds
    return ub


def _ea_group_tables(lr_a, srows):
    """Windowed one-hot extend-add groups from a (B, mp) slab-row table:
    valid (E row, slab row) pairs sorted by slab row, greedily cut at EA_G
    pairs / one ea_window span (shared by the _c and _t bucket makers)."""
    flat = lr_a.reshape(-1)
    v = np.flatnonzero(flat >= 0)
    order = np.argsort(flat[v], kind="stable")
    sv = v[order].astype(np.int64)
    rs = flat[v][order].astype(np.int64)
    Wn = ea_window(srows)
    cuts = [0]
    i = 0
    while i < len(rs):
        rbase = rs[i]
        j = min(i + EA_G, len(rs))
        j = i + int(np.searchsorted(rs[i:j], rbase + Wn))
        i = max(j, i + 1)
        cuts.append(i)
    ng = max(len(cuts) - 1, 1)
    ea_idx = np.zeros(ng * EA_G, np.int32)
    ea_rel = np.full((ng, EA_G), -1, np.int32)
    ea_rbase = np.zeros(ng, np.int32)
    for g in range(len(cuts) - 1):
        a, b2 = cuts[g], cuts[g + 1]
        rb = min(int(rs[a]), max(0, int(srows) - Wn))
        ea_rbase[g] = rb
        ea_idx[g * EA_G: g * EA_G + (b2 - a)] = sv[a:b2]
        ea_rel[g, : b2 - a] = rs[a:b2] - rb
    return ea_idx, ea_rbase, ea_rel


ALIGN = 1024    # f32 HBM DMA tile (spfx.kernels.pallas_blocks.ALIGN)


def _make_update_bucket_t(sel, tid, t_d, t_s, t_lpos, t_N, t_K,
                          u_lpos, u_M, Wp, offsets, first_col, sym, rowpos,
                          mp, kp, csp, qb, srows, W, bshift,
                          idx_dtype=np.int32):
    """M-tiled contig update bucket: each batch item is one (<= mp)-row
    source tile of a task (kp == Wp[d], csp == Wp[s]); the task's N block
    (its leading N source rows, N <= width(s) <= csp) is gathered
    separately via head_start. Slab extend-add exactly as the _c maker.

    ALIGNMENT ABSORPTION: window gathers run as hardware DMAs whose
    source offsets are aligned DOWN to the ALIGN-element HBM tile
    (blocks._task_gather_aligned), so every window is a SUPERWINDOW of
    ext = ALIGN/kp extra rows and the tile's true rows start at
    r0 = (start mod ALIGN)/kp.  All realignment happens here, for free:
    the row masks (rstart), the extend-add row maps, and the head's
    one-hot column map are built against superwindow positions."""
    B = len(sel)
    tk = tid[sel]
    d, s = t_d[tk], t_s[tk]
    lpos, M = u_lpos[sel], u_M[sel]
    hl, N = t_lpos[tk], t_N[tk]
    ext = ALIGN // kp
    src_start = offsets[d] + (lpos + bshift[d]) * Wp[d]
    head_start = offsets[d] + (hl + bshift[d]) * Wp[d]
    r0 = (src_start % ALIGN) // kp
    r0h = (head_start % ALIGN) // kp
    slab_lo = int(offsets[s[0]])
    rows_g = mp + ext
    mi = np.arange(rows_g, dtype=np.int64)[None, :]
    rel = mi - r0[:, None]                 # logical tile row at window row
    vm = (rel >= 0) & (rel < M[:, None])
    pat = np.clip(sym.sn_ptr[d][:, None] + lpos[:, None] + rel,
                  0, len(sym.sn_rows) - 1)
    grow = sym.sn_rows[pat]
    tpos = rowpos(np.broadcast_to(s[:, None], grow.shape).ravel(),
                  grow.ravel()).reshape(grow.shape)
    spos = tpos + np.where(tpos >= W[s][:, None], bshift[s][:, None], 0)
    base_row = (offsets[s] - slab_lo) // csp
    tgt_lrow = np.where(vm & (tpos >= 0), base_row[:, None] + spos, -1)
    # head height: N <= min(task M, width(s)), so the small class needs
    # only an mp-row head; floored at ext so the window is a multiple of
    # ALIGN, plus ext superwindow rows (class tables pad to the class max)
    npw = max(int(min(csp, _pad2(int(N.max()) if len(N) else 1, 8))), ext)
    np_h = npw + ext
    ni = np.arange(np_h, dtype=np.int64)[None, :]
    reln = ni - r0h[:, None]
    vn = (reln >= 0) & (reln < N[:, None])
    patn = np.clip(sym.sn_ptr[d][:, None] + hl[:, None] + reln,
                   0, len(sym.sn_rows) - 1)
    q = sym.sn_rows[patn]
    tgt_cpos = np.where(vn, q - first_col[s][:, None], -1)
    flops = float(2.0 * (M.astype(float) * N * t_K[tk]).sum())
    arrs = _pad_batch([t_K[tk], M, r0, src_start, head_start, tgt_lrow,
                       tgt_cpos], B, qb, [0, 0, 0, -1, -1, -1, -1])
    kw_a, m_a, r0_a, ss_a, hs_a, lr_a, cp_a = \
        (a.astype(idx_dtype) for a in arrs)
    ea_idx, ea_rbase, ea_rel = _ea_group_tables(lr_a, srows)
    sds = _pad_batch([d], B, qb, [-1])[0].astype(np.int64)
    ub = UpdateBucketC(kw_a, m_a, ss_a,
                       np.asarray([slab_lo], idx_dtype), lr_a, cp_a,
                       mp, kp, csp, int(srows), flops,
                       ea_idx=ea_idx, ea_rbase=ea_rbase, ea_rel=ea_rel,
                       ea_ng=np.asarray([len(ea_rbase)], np.int32),
                       head_start=hs_a, rstart=r0_a)
    ub.sds = sds
    return ub


def _make_update_bucket(sel, t_d, t_s, t_lpos, t_M, t_N, t_K,
                        Wp, R, offsets, first_col, sym, rowpos,
                        mp, np_, kp, csp, qb=None, t_cmin=None):
    B = len(sel)
    qb = pad_pow2(B, 1) if qb is None else qb
    d, s = t_d[sel], t_s[sel]
    lpos, M, N, K = t_lpos[sel], t_M[sel], t_N[sel], t_K[sel]
    cmin = t_cmin[sel] if t_cmin is not None else np.zeros(B, np.int64)
    mi = np.arange(mp, dtype=np.int64)[None, :]
    vm = mi < M[:, None]
    src_row_start = np.where(
        vm, offsets[d][:, None] + (lpos[:, None] + mi) * Wp[d][:, None], -1)
    # global rows covered by each task's M window
    pat = np.minimum(sym.sn_ptr[d][:, None] + lpos[:, None] + mi,
                     len(sym.sn_rows) - 1)
    grow = sym.sn_rows[pat]
    tpos = rowpos(np.broadcast_to(s[:, None], grow.shape).ravel(),
                  grow.ravel()).reshape(grow.shape)
    # shift each scatter row start into the task's column window (see
    # build_plan: the one-hot is span-relative, so padded tail columns are
    # exact zeros and row-end overrun is a no-op add)
    tgt_row_start = np.where(
        vm & (tpos >= 0),
        offsets[s][:, None] + tpos * Wp[s][:, None] + cmin[:, None], -1)
    ni = np.arange(np_, dtype=np.int64)[None, :]
    vn = ni < N[:, None]
    patn = np.minimum(sym.sn_ptr[d][:, None] + lpos[:, None] + ni,
                      len(sym.sn_rows) - 1)
    q = sym.sn_rows[patn]
    tgt_cpos = np.where(vn, q - first_col[s][:, None] - cmin[:, None], -1)
    flops = float(2.0 * (M.astype(float) * N * K).sum())
    i32 = np.int32
    arrs = _pad_batch([K, src_row_start, tgt_row_start, tgt_cpos],
                      B, qb, [0, -1, -1, -1])
    return UpdateBucket(*(a.astype(i32) for a in arrs), kp, csp, flops)
