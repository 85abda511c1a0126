"""Level solves of one PC panel bucket, one launch a bucket and sweep.

``level_solve_fwd(F, x, widths, nbelow, diag_start, below_start, xcols,
xrows, cp, rbp, unit)`` and ``level_solve_bwd(...)`` compute what
``blocks.solve_fwd_level_c`` and ``solve_bwd_level_c`` compute, in place on
x (n + 1, nrhs), for every task of one ``PanelBucketC`` (its tables as
``PanelBucketC.to`` gives them, int32):

- forward: y = L11^{-1} x[cols] (L11 unit when ``unit``, LU's L); x[cols]
  = y; x[rows] -= L21 y;
- backward: x[cols] = L11^{-T} (x[cols] - L21^T x[rows]) (LU's F is U^T;
  never unit, nothing conjugated: real factors only);

with L11 and L21 read where they lie in the flat factor F: task t's L11
at ``diag_start[t]`` and its L21 at ``below_start[t]``, row stride cp.
Pad tasks (``diag_start`` -1), dead columns (>= ``widths[t]``), dead rows
(>= ``nbelow[t]``) and -1 indices are skipped: the sentinel row n of x is
never read or written, where the chain's masks write back what they read
there. Returns x.

No Pallas kernel is replaced: the JAX package leaves the level solves to
``lax.linalg`` and XLA. The wrappers launch the kernel of
csrc/level_solve.cu on CUDA tensors and refuse any other. ``takes`` says
which buckets the device solve sends here (``mega.solve_step``): every
``PanelBucketC`` of a real factor on the card, of any width (past
``CP_SHARED`` columns y lives in a global workspace in place of shared
memory); complex factors, rowwin P buckets and the CPU keep the chain.
``level_solve_fwd_plain`` and ``level_solve_bwd_plain`` are the kernel's
algorithm in plain PyTorch (per task over 32-column diagonal blocks, with
predicates in place of masks), on any device, for the checks that hold
the kernel to it; no solve runs them.
"""

from __future__ import annotations

import torch

from spfx_torch.kernels import _cuda

BLK = 32            # diagonal block width
RHS_GROUP = 8       # right-hand sides a thread block (csrc: kRhs)
CH_MAX = 256        # rows a job and a tile of L21, at most (csrc: kChMax)
CH_MIN = 64         # ... and at least (csrc: kChMin)
CP_SHARED = 1024    # the widest bucket whose y the kernel keeps in shared
                    # memory; a wider one keeps it in a global workspace
_GRID_MAX = 65535   # tiles and groups: the grid's y and z extents
_SMEM_BUDGET = 160 * 1024   # bytes of staging that set the buffers' depth


def takes(F, pb) -> bool:
    """Whether the device solve runs bucket ``pb`` of factor array ``F``
    through the kernel: a ``PanelBucketC`` of a float32 or float64 factor
    on a CUDA device. Launches nothing."""
    from spfx_torch.plan.schedule import PanelBucketC
    return (isinstance(pb, PanelBucketC) and F.device.type == "cuda"
            and F.dtype in (torch.float32, torch.float64))


def _check(name: str, F, x, tables, cp: int, rbp: int) -> None:
    """Raise on anything the kernel does not take."""
    widths, nbelow, diag_start, below_start, xcols, xrows = tables
    if F.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: F must be float32 or float64, got "
                        f"{F.dtype}")
    if x.dtype != F.dtype:
        raise TypeError(f"{name}: x is {x.dtype}, F is {F.dtype}")
    if any(t.device != F.device for t in (x, *tables)):
        raise ValueError(f"{name}: F, x and the tables must lie on one "
                         f"device")
    if F.dim() != 1 or not F.is_contiguous():
        raise ValueError(f"{name}: F must be a contiguous flat array")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (n + 1, nrhs) "
                         f"array, got {tuple(x.shape)}")
    if cp < 1:
        raise ValueError(f"{name}: cp must be >= 1, got {cp}")
    if rbp < 0:
        raise ValueError(f"{name}: rbp must be >= 0, got {rbp}")
    B = widths.shape[0]
    shapes = ((B,),) * 4 + ((B, cp), (B, rbp))
    for what, t, want in zip(("widths", "nbelow", "diag_start",
                              "below_start", "xcols", "xrows"), tables,
                             shapes):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {what} must be {want}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if -(-x.shape[1] // RHS_GROUP) > _GRID_MAX \
            or _tiles(rbp, _chunk(cp, rbp)) > _GRID_MAX:
        raise ValueError(f"{name}: nrhs {x.shape[1]} or rbp {rbp} exceeds "
                         f"the grid")
    if F.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on a CUDA device, got "
                         f"{F.device} (the CPU takes the chain)")


def _chunk(cp: int, rbp: int) -> int:
    """Rows a job and a tile of L21 (csrc: ``ch``): the bucket's larger
    extent rounded up to whole diagonal blocks, within [CH_MIN, CH_MAX]."""
    return min(CH_MAX, max(CH_MIN, -(-max(cp, rbp) // BLK) * BLK))


def _tiles(rbp: int, ch: int) -> int:
    return -(-rbp // ch) if rbp > ch else 1


def _y_shared(cp: int) -> bool:
    """Whether the kernel keeps y in shared memory (else in ``yg``)."""
    return cp <= CP_SHARED


def _depth(cp: int, ch: int, item: int) -> int:
    """Staging buffers in flight (csrc: ``nbuf``), 2 to 4, as many as
    _SMEM_BUDGET holds beside y (where it is in shared memory) and the
    tile's x."""
    ypad = -(-cp // BLK) * BLK if _y_shared(cp) else 0
    fixed = (ypad + ch) * RHS_GROUP * item
    return max(2, min(4, (_SMEM_BUDGET - fixed) // (ch * (BLK + 1) * item)))


def _launch(direction: str, F, x, tables, cp: int, rbp: int,
            unit: bool = False):
    """One launch of the forward or backward kernel on CUDA tensors, with
    the arrival counters (zeroed; one int a task and group), for the
    backward the tiles' partial sums that a task spread over more than
    one tile of rows needs, and for a bucket wider than CP_SHARED the
    global workspace of y (a slice a thread block)."""
    B, nrhs = tables[0].shape[0], x.shape[1]
    ch = _chunk(cp, rbp)
    groups, tiles = -(-nrhs // RHS_GROUP), _tiles(rbp, ch)
    cpad = -(-cp // BLK) * BLK
    cnt = ws = yg = None
    if not _y_shared(cp):
        yg = x.new_empty(B * tiles * groups * cpad * RHS_GROUP)
    if tiles > 1:
        cnt = torch.zeros(B * groups, dtype=torch.int32, device=x.device)
        if direction == "bwd":
            ws = x.new_empty(B * groups * tiles * cpad * RHS_GROUP)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    fn = getattr(_cuda.lib("level_solve"), f"spfx_level_solve_{direction}_"
                 + ("f32" if F.dtype == torch.float32 else "f64"))
    head = (F.data_ptr(), x.data_ptr(), *(t.data_ptr() for t in tables),
            ptr(yg))
    tail = (B, cp, rbp, nrhs, ch, _depth(cp, ch, F.element_size()))
    if direction == "fwd":
        rc = fn(*head, ptr(cnt), *tail, int(unit),
                _cuda.stream_ptr(x.device))
    else:
        rc = fn(*head, ptr(ws), ptr(cnt), *tail, _cuda.stream_ptr(x.device))
    _cuda.check(rc, f"level_solve_{direction}")
    if B and nrhs:
        _cuda.count("level_solve")
    return x


def level_solve_fwd(F, x, widths, nbelow, diag_start, below_start, xcols,
                    xrows, cp: int, rbp: int, unit: bool = False):
    """The forward level solve of one PC bucket, in place on x (see the
    module docstring); returns x."""
    tables = (widths, nbelow, diag_start, below_start, xcols, xrows)
    _check("level_solve_fwd", F, x, tables, cp, rbp)
    return _launch("fwd", F, x, tables, cp, rbp, unit)


def level_solve_bwd(F, x, widths, nbelow, diag_start, below_start, xcols,
                    xrows, cp: int, rbp: int):
    """The backward level solve of one PC bucket, in place on x; returns
    x."""
    tables = (widths, nbelow, diag_start, below_start, xcols, xrows)
    _check("level_solve_bwd", F, x, tables, cp, rbp)
    return _launch("bwd", F, x, tables, cp, rbp)


# --------------------------------------------------------------------------
# plain versions: the kernel's algorithm, task by task, for the checks
# --------------------------------------------------------------------------

def _task(F, widths, nbelow, diag_start, below_start, xcols, xrows, t: int,
          cp: int, rbp: int):
    """(L11 (w, w), L21 (nb, w), live columns, live rows) of task t, the
    blocks viewed where they lie; None for a pad task."""
    ds, w = int(diag_start[t]), int(widths[t])
    if ds < 0 or w <= 0:
        return None
    nb = int(nbelow[t]) if rbp else 0
    L11 = F[ds:ds + cp * cp].view(cp, cp)[:w, :w]
    bs = int(below_start[t])
    L21 = F[bs:bs + nb * cp].view(nb, cp)[:, :w] if nb else None
    return L11, L21, xcols[t, :w].long(), xrows[t, :nb].long()


def level_solve_fwd_plain(F, x, widths, nbelow, diag_start, below_start,
                          xcols, xrows, cp: int, rbp: int,
                          unit: bool = False):
    """Plain PyTorch version of the forward kernel: per task, the
    substitution within each 32-column diagonal block, then the rows below
    it within L11, then x[rows] -= L21 y."""
    for t in range(widths.shape[0]):
        part = _task(F, widths, nbelow, diag_start, below_start, xcols,
                     xrows, t, cp, rbp)
        if part is None:
            continue
        L11, L21, cols, rows = part
        w = L11.shape[0]
        live = cols >= 0
        y = x.new_zeros((w, x.shape[1]))
        y[live] = x[cols[live]]
        for c0 in range(0, w, BLK):
            e = min(c0 + BLK, w)
            for c in range(c0, e):
                if not unit:
                    y[c] = y[c] / L11[c, c]
                y[c + 1:e] -= L11[c + 1:e, c, None] * y[c]
            y[e:] -= L11[e:, c0:e] @ y[c0:e]
        x[cols[live]] = y[live]
        if L21 is not None:
            lr = rows >= 0
            x.index_add_(0, rows[lr], (L21 @ y)[lr], alpha=-1)
    return x


def level_solve_bwd_plain(F, x, widths, nbelow, diag_start, below_start,
                          xcols, xrows, cp: int, rbp: int):
    """Plain PyTorch version of the backward kernel: per task, t = x[cols]
    - L21^T x[rows], then the back substitution with L11^T from the last
    32-column block to the first, each block's solved values taken out of
    the rows above it."""
    for t in range(widths.shape[0]):
        part = _task(F, widths, nbelow, diag_start, below_start, xcols,
                     xrows, t, cp, rbp)
        if part is None:
            continue
        L11, L21, cols, rows = part
        w = L11.shape[0]
        live = cols >= 0
        y = x.new_zeros((w, x.shape[1]))
        y[live] = x[cols[live]]
        if L21 is not None:
            lr = rows >= 0
            y -= L21[lr].T @ x[rows[lr]]
        for c0 in reversed(range(0, w, BLK)):
            e = min(c0 + BLK, w)
            for c in reversed(range(c0, e)):
                y[c] = y[c] / L11[c, c]
                y[c0:c] -= L11[c, c0:c, None] * y[c]
            y[:c0] -= L11[c0:e, :c0].T @ y[c0:e]
        x[cols[live]] = y[live]
    return x
