"""Supernodal sparse Cholesky: numeric engine + factor object.

Port of spfx/chol/factorize.py. The host builds the same symbolic analysis
and the same static plan as the JAX package (``spfx_torch.symbolic``,
``spfx_torch.plan``). The device then scatters the permuted lower-triangle
values into one flat panel tensor and walks the plan's levels, in place:
each level's update buckets (UT by default, ``blocks.apply_updates_sym_t``;
UC under ``update_tile=0``; rowwin U under ``layout="rowwin"``), then its
panel buckets (PC, ``blocks.factor_panels_chol_u``; rowwin P), with the
panel-kernel family that ``SPFX_PANEL_KERNEL`` selects, read once per
factorization (``kernels/route.py``). The walk is
``kernels.mega.MegaRunner``'s: with the default ``engine="mega"`` one
CUDA-graph replay per factorization on the card, with ``engine="calls"``
the eager walk; ``engine="fused"`` (rowwin plans) runs it in chunks of
levels, one graph each (``kernels.fused.FusedRunner``).

The solve runs the native f64 supernodal solve on the copied-back factor
(``solve_backend="host"``, and ``"auto"`` where the native library is
there), or the level-batched triangular solves on the device
(``kernels.mega.MegaSolver``; ``"device"``, and ``"auto"`` without the
native library), with f64 iterative refinement on the host either way.
A complex factor (``Config(dtype="complex64"|"complex128")``: A = L L^H,
Hermitian positive definite) always takes the device solve and refines
in complex128, as the JAX package does.

Everything runs on the CUDA device unless the caller passes ``device``
(the tests pass ``"cpu"``, where every kernel wrapper takes its plain
PyTorch version); with no CUDA device and no ``device`` given, the entry
points raise.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from spfx_torch.kernels.mega import _PRECISION, MegaRunner, MegaSolver
from spfx_torch.plan.schedule import (ALIGN, FactorPlan, PanelBucketC,
                                     UpdateBucketC, build_plan)
from spfx_torch.symbolic.analyze import Symbolic, analyze
from spfx_torch.utils import instrument
from spfx_torch.utils.config import Config, DEFAULT

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "complex64": torch.complex64, "complex128": torch.complex128}


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the CUDA device; raises when neither."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("spfx_torch: no CUDA device; pass device='cpu' "
                           "to run the plain PyTorch path")
    return torch.device("cuda", torch.cuda.current_device())


def engine_of(config: Config) -> str:
    """The config's engine: "mega", "calls" or "fused" (``fused=True`` is
    the deprecated alias of ``engine="fused"``)."""
    return "fused" if config.fused else config.engine


def check_config(config: Config) -> None:
    """Raise on an option value the port does not know."""
    if config.layout not in ("contig", "rowwin"):
        raise ValueError(f"unknown layout {config.layout!r}")
    if config.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {config.dtype!r}")
    if config.solve_backend not in ("auto", "host", "device"):
        raise ValueError(f"unknown solve_backend {config.solve_backend!r}")
    if engine_of(config) not in ("mega", "calls", "fused"):
        raise ValueError(f"unknown engine {config.engine!r}")
    for p in (config.matmul_precision, config.update_precision):
        if p is not None and p not in _PRECISION:
            raise ValueError(f"unknown matmul precision {p!r}")


def _check_starts(starts, extent: int, storage: int, what: str) -> None:
    s = np.asarray(starts, np.int64)
    s = s[s >= 0]
    if len(s) and s.max() + extent > storage:
        raise ValueError(f"plan has {what} past the end of storage")


def check_windows(plan: FactorPlan) -> None:
    """Every window a step reads or writes ends inside the flat storage,
    for each bucket kind by its own tables: the gathers never clip. UT: the
    aligned-down source and head superwindows. UC: the (mp x kp) source
    window. Rowwin U and P: every row window. PC: the bucket's block. And
    every extend-add (UT, UC) stays in its slab: the slab ends inside the
    storage, the row table has one entry per row of the step's E (UT: B *
    (mp + ALIGN/kp), UC: B * mp), and every live entry is a row of the slab
    (the kernel traps on one that is not); every placed column is one of
    the target's."""
    st = plan.storage
    for lp in plan.levels:
        for ub in lp.updates:
            if np.asarray(ub.tgt_cpos).max(initial=-1) >= ub.csp:
                raise ValueError("plan has an update column past its "
                                 "target width")
            if not isinstance(ub, UpdateBucketC):
                _check_starts(ub.src_row_start, ub.kp, st,
                              "a source row window")
                _check_starts(ub.tgt_row_start, ub.csp, st,
                              "a target row window")
                continue
            if ub.head_start is not None:
                ext = ALIGN // ub.kp
                for starts, rows in ((ub.src_start, ub.mp + ext),
                                     (ub.head_start, ub.tgt_cpos.shape[1])):
                    s = np.asarray(starts, np.int64)
                    _check_starts(np.where(s >= 0, s // ALIGN * ALIGN, -1),
                                  rows * ub.kp, st, "a gather superwindow")
            else:
                ext = 0
                _check_starts(ub.src_start, ub.mp * ub.kp, st,
                              "a source window")
            if int(ub.slab_lo[0]) + ub.slab_rows * ub.csp > st:
                raise ValueError("plan has an extend-add slab past the end "
                                 "of storage")
            if ub.tgt_lrow.size != len(ub.kw) * (ub.mp + ext):
                raise ValueError(
                    f"plan has an extend-add row table of {ub.tgt_lrow.size}"
                    f" entries for {len(ub.kw) * (ub.mp + ext)} update rows")
            if ub.tgt_lrow.size and int(ub.tgt_lrow.max()) >= ub.slab_rows:
                raise ValueError("plan has an extend-add row past its slab")
        for pb in lp.panels:
            if isinstance(pb, PanelBucketC):
                _check_starts(pb.slab_lo, len(pb.widths) * (pb.cp + pb.rbp)
                              * pb.cp, st, "a panel block")
            else:
                cp = pb.diag_row_start.shape[1]
                _check_starts(pb.diag_row_start, cp, st,
                              "a diagonal row window")
                _check_starts(pb.below_row_start, cp, st,
                              "a below row window")


def make_engine(ctx, lu: bool):
    """The (runner, solver) pair of a context's engine: ``FusedRunner`` /
    ``FusedSolver`` for "fused" (rowwin plans only: raises ValueError on a
    contig plan), else ``MegaRunner`` / ``MegaSolver``."""
    if engine_of(ctx.config) == "fused":
        from spfx_torch.kernels.fused import FusedRunner, FusedSolver
        kinds = FusedRunner, FusedSolver
    else:
        kinds = MegaRunner, MegaSolver
    return tuple(k(ctx.plan, lu=lu, config=ctx.config, device=ctx.device)
                 for k in kinds)


def use_host_solve(config: Config) -> bool:
    """Whether a factor solves on the host: ``solve_backend="host"``
    (raises without the native library), or ``"auto"`` with the native
    library there; otherwise on the device. A complex factor always
    solves on the device (the native solve is real), whatever the
    backend, as in the JAX package."""
    from spfx_torch.symbolic import _native
    if config.solve_backend == "device" or "complex" in config.dtype:
        return False
    ok = _native.available()
    if config.solve_backend == "host" and not ok:
        raise RuntimeError("host solve requested but the native planner "
                           "library is missing")
    return ok


def device_solve(f, F, G, b: np.ndarray) -> np.ndarray:
    """One forward (over F) and backward (over G) supernodal solve pass of
    factor ``f`` on its device, in the factor's dtype: b permuted by
    ``f._inperm`` on the way in and by ``sym.perm`` on the way out. The
    factor's ``MegaSolver`` is made at first use if the factor has none;
    its solve graphs stay on the factor."""
    n = f.sym.n
    squeeze = b.ndim == 1
    with instrument.span("spfx.solve.stage_in"):
        b2 = np.asarray(b).reshape(n, -1)
        xp = np.zeros((n + 1, b2.shape[1]), dtype=f.config.dtype)
        xp[:n] = b2[f._inperm]
        xd = torch.from_numpy(xp).to(F.device)
    if f._solver is None:
        f._solver = MegaSolver(f.plan, lu=hasattr(f, "Ux"), config=f.config,
                               device=F.device)
    x = f._solver.solve(F, G, xd, f._solve_graphs)
    with instrument.span("spfx.solve.stage_out"):
        xh = x[:n].cpu().numpy()
        out = np.empty_like(xh)
        out[f.sym.perm] = xh
    return out[:, 0] if squeeze else out


def refined_solve(solve1, A, config: Config, b, refine: int | None):
    """Solve A x = b with ``solve1`` (the factor's host or device solve), then
    ``refine`` sweeps of iterative refinement against A (the config's
    ``refine_iters`` when None), stopping early once the residual is under
    ``config.refine_tol``. Refinement runs in f64, or in complex128 for a
    complex right-hand side or factor.

    Recorded: the span ``spfx.solve`` (a request, unless inside one), a
    ``spfx.solve.pass`` around each ``solve1`` call and a
    ``spfx.refine.residual`` around each residual and its norm; the
    counters ``solve_requests``, ``solve_passes``, ``refine_sweeps`` and
    ``refine_capped`` (every sweep made and no residual under the
    tolerance)."""
    with instrument.span("spfx.solve"):
        instrument.count("solve_requests")
        refine = config.refine_iters if refine is None else refine
        b = np.asarray(b)
        wide = np.complex128 if (np.iscomplexobj(b)
                                 or "complex" in config.dtype) \
            else np.float64
        b = b.astype(wide)
        x = _solve_pass(solve1, b).astype(wide)
        if refine <= 0:
            return x
        bn = np.abs(b).max() + 1e-300
        for _ in range(refine):
            with instrument.span("spfx.refine.residual"):
                r = b - A @ x
                met = np.abs(r).max() / bn < config.refine_tol
            if met:
                break
            instrument.count("refine_sweeps")
            x = x + _solve_pass(solve1, r).astype(wide)
        else:
            instrument.count("refine_capped")
        return x


def _solve_pass(solve1, b):
    """One ``solve1`` call, as the span ``spfx.solve.pass``."""
    with instrument.span("spfx.solve.pass"):
        instrument.count("solve_passes")
        return solve1(b)


def permuted_entries(sym: Symbolic, A: sp.spmatrix, lu: bool = False) -> list:
    """The host arrays of A's permuted lower-triangle entry values (LU: and
    of the strict upper triangle's, transposed), in A's own dtype, in the
    order the plan's assembly takes them."""
    Ap = sp.csc_matrix(A)[sym.perm][:, sym.perm]
    parts = [sp.tril(Ap).tocsc()] + ([sp.tril(Ap.T, -1).tocsc()] if lu
                                      else [])
    return [m.data for m in parts]


def entry_values(sym: Symbolic, A: sp.spmatrix, dtype: str, device,
                 lu: bool = False) -> tuple:
    """The permuted lower-triangle entry values of A on ``device`` (LU: and
    the strict upper triangle's, transposed), in ``dtype``: the host work
    as the span ``spfx.entry.permute``, the copy as ``spfx.entry.copy``,
    its bytes counted as ``entry_bytes``."""
    with instrument.span("spfx.entry.permute"):
        host = [d.astype(dtype) for d in permuted_entries(sym, A, lu)]
    with instrument.span("spfx.entry.copy"):
        out = tuple(torch.as_tensor(h, device=device) for h in host)
    instrument.count("entry_bytes", sum(h.nbytes for h in host))
    return out


class EntryMap:
    """A context's entry values as one gather on the device, through a map
    built once from the analysed pattern: element k of entry-values array
    j is ``A.data[src[j][k]]`` for every A of that pattern (the same
    shape, ``indptr`` and ``indices``).

    ``host(M)`` is the context's host pipeline (``permuted_entries``, after
    the static pivot's rows for LU); the map is what it gives on a copy of
    the pattern whose values are 1 .. nnz in float64, exact, and none of
    them zero. A cast commutes with a gather, so the mapped values are bit
    for bit the pipeline's. A context builds none for a matrix that is not
    in canonical format as the caller gives it (the pipeline would sum its
    duplicates), and decides that before its analysis, which may sort the
    matrix's arrays in place."""

    def __init__(self, A: sp.csc_matrix, host, device):
        self.shape = A.shape
        self.indptr, self.indices = A.indptr, A.indices
        probe = sp.csc_matrix((np.arange(1, A.nnz + 1, dtype=np.float64),
                               A.indices, A.indptr), shape=A.shape)
        self.device = device
        self.src = tuple(torch.as_tensor(d.astype(np.int64) - 1,
                                         device=device)
                         for d in host(probe))

    def matches(self, A: sp.csc_matrix) -> bool:
        """Whether A has the map's pattern (identity first, then values)."""
        return A.shape == self.shape and all(
            a is b or np.array_equal(a, b)
            for a, b in ((A.indptr, self.indptr), (A.indices, self.indices)))

    def __call__(self, A: sp.csc_matrix, dtype: str) -> tuple | None:
        """A's entry values on the map's device, as ``entry_values`` gives
        them, counted ``entry_mapped``; None when A has another pattern.
        The check and the cast are the span ``spfx.entry.permute``; the
        copy of A's values and the gather, ``spfx.entry.copy``, its bytes
        counted as ``entry_bytes``."""
        with instrument.span("spfx.entry.permute"):
            if not self.matches(A):
                return None
            host = A.data.astype(dtype)
        with instrument.span("spfx.entry.copy"):
            flat = torch.as_tensor(host, device=self.device)
            out = tuple(flat.index_select(0, s) for s in self.src)
        instrument.count("entry_mapped")
        instrument.count("entry_bytes", host.nbytes)
        return out


def lower_entries(sym: Symbolic, plan: FactorPlan) -> tuple:
    """(rows, cols, flat positions) of every entry on or below the diagonal
    of the factor's panels: supernode s's column c1 + c, row r lies at
    offsets[s] + r' * strides[s] + c in its row-major panel, r' being r's
    storage row (below rows shifted by ``plan.below_shift``)."""
    rows, cols, pos = [], [], []
    shift = plan.below_shift
    for s in range(sym.nsuper):
        c1, c2 = sym.sn_start[s], sym.sn_start[s + 1]
        rr = sym.sn_row_list(s)
        w = c2 - c1
        sr = np.arange(len(rr))
        if shift is not None:
            sr = sr + np.where(sr >= w, shift[s], 0)
        cc = c1 + np.arange(w)
        keep = rr[:, None] >= cc[None, :]               # (rows, w)
        rows.append(np.broadcast_to(rr[:, None], keep.shape)[keep])
        cols.append(np.broadcast_to(cc[None, :], keep.shape)[keep])
        pos.append((plan.offsets[s] + sr[:, None] * int(plan.strides[s])
                    + np.arange(w)[None, :])[keep])
    return tuple(np.concatenate(x) for x in (rows, cols, pos))


class CholeskyFactor:
    """Factorized P A P^T = L L^T: the flat panel tensor ``L`` on the
    context's device, with the host or the device solve."""

    def __init__(self, A: sp.spmatrix, sym: Symbolic, plan: FactorPlan,
                 L: torch.Tensor, config: Config, solver=None):
        self.A = sp.csc_matrix(A)
        self.sym = sym
        self.plan = plan
        self.L = L
        self.config = config
        self._solver = solver      # the context's MegaSolver, if given
        self._solve_graphs = {}    # nrhs -> the device solve's graph
        self._inperm = sym.perm
        self._Lh = None

    def host_factor(self) -> np.ndarray:
        """The flat factor as a contiguous numpy array (copied once)."""
        if self._Lh is None:
            self._Lh = np.ascontiguousarray(self.L.detach().cpu().numpy())
        return self._Lh

    # -- solves -----------------------------------------------------------

    def _use_host_solve(self) -> bool:
        return use_host_solve(self.config)

    def _solve_host(self, b: np.ndarray) -> np.ndarray:
        """Native C++ supernodal solve on the copied-back factor (f64)."""
        from spfx_torch.symbolic import _native
        Lh = self.host_factor()
        n = self.sym.n
        squeeze = b.ndim == 1
        b2 = np.asarray(b, dtype=np.float64).reshape(n, -1)
        out = np.empty_like(b2)
        for j in range(b2.shape[1]):
            x = np.ascontiguousarray(b2[self.sym.perm, j])
            _native.chol_solve_host(self.sym, self.plan, Lh, x)
            out[self.sym.perm, j] = x
        return out[:, 0] if squeeze else out

    def _solve_device(self, b: np.ndarray) -> np.ndarray:
        """One forward+backward supernodal solve pass on the device."""
        return device_solve(self, self.L, self.L, b)

    def solve(self, b: np.ndarray, refine: int | None = None) -> np.ndarray:
        """Solve A x = b with f64 (complex: complex128) iterative
        refinement (mixed precision)."""
        solve1 = self._solve_host if self._use_host_solve() \
            else self._solve_device
        return refined_solve(solve1, self.A, self.config, b, refine)

    # -- introspection ----------------------------------------------------

    def L_sparse(self) -> sp.csc_matrix:
        """Reconstruct L (of P A P^T) as scipy CSC — test/debug path."""
        rows, cols, pos = lower_entries(self.sym, self.plan)
        return sp.csc_matrix((self.host_factor()[pos], (rows, cols)),
                             shape=(self.sym.n, self.sym.n))

    def logdet(self) -> float:
        """log det(A) = 2 * sum(log diag(L)) — uses valid diagonal slots
        (a complex L's diagonal is real)."""
        sym = self.sym
        Lh = self.host_factor().real.astype(np.float64)
        tot = 0.0
        for s in range(sym.nsuper):
            c1, c2 = sym.sn_start[s], sym.sn_start[s + 1]
            w = c2 - c1
            wp = int(self.plan.strides[s])
            off = self.plan.offsets[s]
            d = Lh[off + np.arange(w) * wp + np.arange(w)]  # panel diagonal
            tot += np.log(d).sum()
        return 2.0 * tot


class Cholesky:
    """Reusable symbolic+plan context: factorize many same-pattern matrices
    on one device."""

    def __init__(self, A: sp.spmatrix, config: Config = DEFAULT,
                 sym: Symbolic | None = None, device=None):
        check_config(config)
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.dtype]
        A = sp.csc_matrix(A)
        self.A = A
        self.config = config
        canonical = A.has_canonical_format     # before the analysis
        with instrument.timed("spfx.analyze") as span:
            self.sym = sym if sym is not None else analyze(A, config)
        self.analyze_time = span.seconds
        with instrument.timed("spfx.plan") as span:
            self.plan = build_plan(self.sym, A, config)
            self._entry_map = EntryMap(
                A, lambda M: permuted_entries(self.sym, M),
                self.device) if canonical else None
            span.set(**instrument.plan_attrs(self.plan, self.dtype, 1))
        self.plan_time = span.seconds
        check_windows(self.plan)
        self._runner = None
        self._solver = None

    def entry_values(self, A: sp.spmatrix) -> torch.Tensor:
        """Permuted lower-triangle entry values — the only data that crosses
        the host->device link per factorization: through the context's
        ``EntryMap`` when A has the analysed pattern, else the host
        pipeline, counted ``entry_fallback``."""
        A = sp.csc_matrix(A)
        out = None if self._entry_map is None else \
            self._entry_map(A, self.config.dtype)
        if out is None:
            instrument.count("entry_fallback")
            out = entry_values(self.sym, A, self.config.dtype, self.device)
        return out[0]

    def factorize(self, A: sp.spmatrix) -> CholeskyFactor:
        with instrument.timed("spfx.factorize",
                              dtype=self.config.dtype) as req:
            A = sp.csc_matrix(A)
            vals = self.entry_values(A)
            if self._runner is None:
                self._runner, self._solver = make_engine(self, lu=False)
            with instrument.profile_scope(self.config, "factorize"):
                if engine_of(self.config) == "calls":
                    L = self._runner.trace_fn()(vals)
                else:
                    L = self._runner.run(vals)  # graph replays on the card
            f = CholeskyFactor(A, self.sym, self.plan, L, self.config,
                               solver=self._solver)
            return instrument.finish_factorize(self, f, req.start_s)


def cholesky(A: sp.spmatrix, config: Config = DEFAULT,
             device=None) -> CholeskyFactor:
    """One-shot: analyze + plan + numeric factorization of SPD A."""
    return Cholesky(A, config, device=device).factorize(A)
