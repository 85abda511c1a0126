"""Supernodal sparse Cholesky: numeric engine + factor object.

Port of spfx/chol/factorize.py. The host builds the same symbolic analysis
and the same static plan as the JAX package (``spfx_torch.symbolic``,
``spfx_torch.plan``). The device then scatters the permuted lower-triangle
values into one flat panel tensor and walks the plan's levels, in place:
each level's UT update buckets (``blocks.apply_updates_sym_t``), then its
PC panel buckets (``blocks.factor_panels_chol_u``), with the panel-kernel
family that ``SPFX_PANEL_KERNEL`` selects, read once per factorization
(``kernels/route.py``). The solve copies the factor back and runs the native f64 supernodal solve with iterative
refinement on the host.

Everything runs on the CUDA device unless the caller passes ``device``
(the tests pass ``"cpu"``, where every kernel wrapper takes its plain
PyTorch version); with no CUDA device and no ``device`` given, the entry
points raise.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from spfx_torch.kernels import blocks, route
from spfx_torch.plan.schedule import ALIGN, FactorPlan, build_plan
from spfx_torch.symbolic.analyze import Symbolic, analyze
from spfx_torch.utils.config import Config, DEFAULT

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# JAX matmul precision -> torch float32 matmul precision. "default" and
# "bfloat16" (one bf16 pass on the TPU) become TF32, which is finer. JAX's
# "high" is bf16x3 (~1e-6 relative); torch has no such mode, and TF32 (a
# 10-bit mantissa) would be coarser, so check_config refuses it.
_PRECISION = {"highest": "highest", "float32": "highest",
              "default": "medium", "bfloat16": "medium"}


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the CUDA device; raises when neither."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("spfx_torch: no CUDA device; pass device='cpu' "
                           "to run the plain PyTorch path")
    return torch.device("cuda", torch.cuda.current_device())


def check_config(config: Config) -> None:
    """Raise on the options this port does not implement yet."""
    if config.layout != "contig":
        raise NotImplementedError(
            "layout='rowwin' is not ported (ROADMAP Queue 1 item 6)")
    if not int(config.update_tile or 0):
        raise NotImplementedError(
            "update_tile=0 (UC buckets) is not ported (ROADMAP Queue 1 "
            "item 6)")
    if "complex" in config.dtype:
        raise NotImplementedError(
            "complex dtypes are not ported (ROADMAP Queue 1 item 6)")
    if config.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {config.dtype!r}")
    if config.solve_backend == "device":
        raise NotImplementedError(
            "solve_backend='device' is not ported (ROADMAP Queue 1 item 4)")
    if config.fused or config.engine == "fused":
        raise NotImplementedError(
            "engine='fused' is not ported (ROADMAP Queue 1 item 6)")
    if config.engine not in ("mega", "calls"):
        raise ValueError(f"unknown engine {config.engine!r}")
    for p in (config.matmul_precision, config.update_precision):
        if p == "high":
            raise NotImplementedError(
                "matmul precision 'high' (bf16x3) is not ported (ROADMAP "
                "Queue 1 item 6)")
        if p is not None and p not in _PRECISION:
            raise ValueError(f"unknown matmul precision {p!r}")


@contextlib.contextmanager
def matmul_precision(name: str):
    """float32 matrix products at the JAX precision ``name`` ("highest":
    full float32, no TF32), restored afterwards."""
    old = torch.get_float32_matmul_precision()
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision(_PRECISION[name])
    torch.backends.cuda.matmul.allow_tf32 = _PRECISION[name] != "highest"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)
        torch.backends.cuda.matmul.allow_tf32 = old_tf32


def check_windows(plan: FactorPlan) -> None:
    """Every live aligned-down gather superwindow of every UT bucket ends
    inside the flat storage: the gather kernels never clip. And every
    extend-add stays in its slab: the slab ends inside the storage, the
    row table has one entry per row of the step's E, B * (mp + ALIGN/kp),
    and every live entry is a row of the slab (the kernel traps on one
    that is not)."""
    for lp in plan.levels:
        for ub in lp.updates:
            ext = ALIGN // ub.kp
            for starts, rows in ((ub.src_start, ub.mp + ext),
                                 (ub.head_start, ub.tgt_cpos.shape[1])):
                s = np.asarray(starts, np.int64)
                s = s[s >= 0]
                if len(s) and (s // ALIGN * ALIGN + rows * ub.kp).max() \
                        > plan.storage:
                    raise ValueError("plan has a gather superwindow past "
                                     "the end of storage")
            if int(ub.slab_lo[0]) + ub.slab_rows * ub.csp > plan.storage:
                raise ValueError("plan has an extend-add slab past the end "
                                 "of storage")
            if ub.tgt_lrow.size != len(ub.kw) * (ub.mp + ext):
                raise ValueError(
                    f"plan has an extend-add row table of {ub.tgt_lrow.size}"
                    f" entries for {len(ub.kw) * (ub.mp + ext)} update rows")
            if ub.tgt_lrow.size and int(ub.tgt_lrow.max()) >= ub.slab_rows:
                raise ValueError("plan has an extend-add row past its slab")


def update_precision(config: Config):
    """The context for the UT update steps inside the walk's
    ``matmul_precision(config.matmul_precision)``: a no-op unless
    ``config.update_precision`` names another torch mode."""
    upd = config.update_precision or config.matmul_precision
    if _PRECISION[upd] == _PRECISION[config.matmul_precision]:
        return contextlib.nullcontext
    return functools.partial(matmul_precision, upd)


def finish_factorize(ctx, f, t0: float):
    """Wait for the device, record the factorization's wall time since
    ``t0`` on ``ctx``, then honour ``config.profile`` (a timing line on
    stderr) and ``config.validate`` (the refined solve's scaled residual
    as ``f.residual``, with a warning above 1e-8)."""
    cfg = ctx.config
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    ctx.factorize_time = time.perf_counter() - t0
    if cfg.profile:
        print(f"[spfx_torch profile] analyze {ctx.analyze_time:.3f}s  "
              f"plan {ctx.plan_time:.3f}s  "
              f"factorize {ctx.factorize_time:.3f}s  "
              f"({ctx.plan.flops / max(ctx.factorize_time, 1e-12) / 1e9:.1f}"
              " GFLOP/s)", file=sys.stderr, flush=True)
    if cfg.validate:
        from spfx_torch.validate import scaled_residual, synth_rhs
        b = synth_rhs(f.A)
        f.residual = scaled_residual(f.A, f.solve(b), b)
        if not f.residual < 1e-8:
            print(f"[spfx_torch] WARNING: scaled residual "
                  f"{f.residual:.3e} exceeds 1e-8 validation gate",
                  file=sys.stderr, flush=True)
    return f


def refined_solve(solve1, A, config: Config, b, refine: int | None):
    """Solve A x = b with ``solve1`` (the factor's host f64 solve), then
    ``refine`` sweeps of f64 iterative refinement against A (the
    config's ``refine_iters`` when None), stopping early once the residual
    is under ``config.refine_tol``."""
    refine = config.refine_iters if refine is None else refine
    b = np.asarray(b).astype(np.float64)
    x = solve1(b)
    if refine <= 0:
        return x
    bn = np.abs(b).max() + 1e-300
    for _ in range(refine):
        r = b - A @ x
        if np.abs(r).max() / bn < config.refine_tol:
            break
        x = x + solve1(r)
    return x


class CholeskyFactor:
    """Factorized P A P^T = L L^T: the flat panel tensor ``L`` on the
    context's device, with the host f64 solve."""

    def __init__(self, A: sp.spmatrix, sym: Symbolic, plan: FactorPlan,
                 L: torch.Tensor, config: Config):
        self.A = sp.csc_matrix(A)
        self.sym = sym
        self.plan = plan
        self.L = L
        self.config = config
        self._Lh = None

    def host_factor(self) -> np.ndarray:
        """The flat factor as a contiguous numpy array (copied once)."""
        if self._Lh is None:
            self._Lh = np.ascontiguousarray(self.L.detach().cpu().numpy())
        return self._Lh

    # -- solves -----------------------------------------------------------

    def _solve_host(self, b: np.ndarray) -> np.ndarray:
        """Native C++ supernodal solve on the copied-back factor (f64)."""
        from spfx_torch.symbolic import _native
        if not _native.available():
            raise RuntimeError("spfx_torch solve needs the native planner "
                               "library (no device solve yet)")
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

    def solve(self, b: np.ndarray, refine: int | None = None) -> np.ndarray:
        """Solve A x = b with f64 iterative refinement (mixed precision)."""
        return refined_solve(self._solve_host, self.A, self.config, b, refine)

    # -- introspection ----------------------------------------------------

    def L_sparse(self) -> sp.csc_matrix:
        """Reconstruct L (of P A P^T) as scipy CSC — test/debug path."""
        sym = self.sym
        Lh = self.host_factor()
        rows, cols, vals = [], [], []
        shift = self.plan.below_shift
        for s in range(sym.nsuper):
            c1, c2 = sym.sn_start[s], sym.sn_start[s + 1]
            rr = sym.sn_row_list(s)
            R = len(rr)
            w = c2 - c1
            wp = int(self.plan.strides[s])
            off = self.plan.offsets[s]
            sr = np.arange(R)
            if shift is not None:
                sr = sr + np.where(sr >= w, shift[s], 0)
            for c in range(w):
                v = Lh[off + sr * wp + c]              # row-major panel
                keep = rr >= c1 + c
                rows.append(rr[keep])
                cols.append(np.full(keep.sum(), c1 + c))
                vals.append(v[keep])
        return sp.csc_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(sym.n, sym.n))

    def logdet(self) -> float:
        """log det(A) = 2 * sum(log diag(L)) — uses valid diagonal slots."""
        sym = self.sym
        Lh = self.host_factor().astype(np.float64)
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
        t0 = time.perf_counter()
        self.sym = sym if sym is not None else analyze(A, config)
        self.analyze_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.plan = build_plan(self.sym, A, config)
        self.plan_time = time.perf_counter() - t0
        check_windows(self.plan)
        self._asm_idx = None

    def entry_values(self, A: sp.spmatrix) -> torch.Tensor:
        """Permuted lower-triangle entry values — the only data that crosses
        the host->device link per factorization."""
        Ap = sp.csc_matrix(A)[self.sym.perm][:, self.sym.perm]
        low = sp.tril(Ap).tocsc()
        return torch.as_tensor(low.data.astype(self.config.dtype),
                               device=self.device)

    def factorize(self, A: sp.spmatrix) -> CholeskyFactor:
        A = sp.csc_matrix(A)
        cfg = self.config
        dev = self.device
        mode = route.panel_mode()      # SPFX_PANEL_KERNEL, once a call
        t0 = time.perf_counter()
        vals = self.entry_values(A)
        if self._asm_idx is None:
            self._asm_idx = torch.as_tensor(
                self.plan.assembly_idx.astype(np.int64), device=dev)
        L = blocks.assemble(self._asm_idx, vals, self.plan.storage)
        upd_ctx = update_precision(cfg)
        with matmul_precision(cfg.matmul_precision):
            for lp in self.plan.levels:
                # left-looking: drain this level's pending updates, then
                # factor its panels
                with upd_ctx():
                    for ub in lp.updates:
                        (kw, mrows, rstart, src_start, head_start,
                         *_, tgt_cpos) = ub.to(dev)
                        blocks.apply_updates_sym_t(
                            L, kw, mrows, rstart, src_start, head_start,
                            int(ub.slab_lo[0]), ub.rows_to(dev), tgt_cpos,
                            mp=ub.mp, kp=ub.kp, csp=ub.csp,
                            srows=ub.slab_rows)
                for pb in lp.panels:
                    widths, nbelow, _ = pb.to_u(dev)
                    blocks.factor_panels_chol_u(
                        L, widths, nbelow, int(pb.slab_lo[0]),
                        cp=pb.cp, rbp=pb.rbp, mode=mode)
        f = CholeskyFactor(A, self.sym, self.plan, L, cfg)
        return finish_factorize(self, f, t0)


def cholesky(A: sp.spmatrix, config: Config = DEFAULT,
             device=None) -> CholeskyFactor:
    """One-shot: analyze + plan + numeric factorization of SPD A."""
    return Cholesky(A, config, device=device).factorize(A)
