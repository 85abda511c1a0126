"""Supernodal sparse LU without pivoting: numeric engine + factor object.

Port of spfx/lu/factorize.py. The symbolic analysis runs on the pattern of
A + A^T, so L and U^T share one supernode structure and one panel layout:
the flat tensor ``Lx`` holds L (unit diagonal), ``Ux`` holds U^T (U's
diagonal on its diagonal), slot for slot. The device scatters the permuted
L-lower and U^T strict-lower values into the two tensors and walks the
plan's levels in place, as the Cholesky executor does: each level's
update buckets (UT, ``blocks.apply_updates_lu_t``; UC or rowwin U under
the other configs), then its panel buckets (PC,
``blocks.factor_panels_lu_u``; rowwin P; routed by ``SPFX_PANEL_KERNEL``
as for Cholesky), through ``kernels.mega.MegaRunner`` (one CUDA-graph
replay per factorization on the card with ``engine="mega"``, the eager
walk with ``"calls"``) or ``kernels.fused.FusedRunner``
(``engine="fused"``). The solve runs the native f64 supernodal solve on the
copied-back factors or the device's level solves (``solve_backend``, as
for Cholesky), with f64 iterative refinement against the user's matrix on
the host.

Like the reference, the factorization does not pivot: it needs a matrix
that factors without pivoting (diagonally dominant, or made so by the
optional host-side static pivot, ``Config(static_pivot=True)``).

Device policy as in ``spfx_torch.chol.factorize``: CUDA unless the caller
passes ``device``; with neither, the entry points raise.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from spfx_torch.chol.factorize import (
    _DTYPES, EntryMap, check_config, check_windows, device_solve, engine_of,
    entry_values, lower_entries, make_engine, permuted_entries, refined_solve,
    resolve_device, use_host_solve)
from spfx_torch.plan.schedule import FactorPlan, build_plan
from spfx_torch.symbolic.analyze import Symbolic, analyze
from spfx_torch.utils import instrument
from spfx_torch.utils.config import Config, DEFAULT


class LUFactor:
    """Factorized P A P^T = L U (unit-diagonal L, no pivoting): the flat
    tensors ``Lx`` (L) and ``Ux`` (U^T) on the context's device, with the
    host or the device solve."""

    def __init__(self, A: sp.spmatrix, sym: Symbolic, plan: FactorPlan,
                 Lx: torch.Tensor, Ux: torch.Tensor, config: Config,
                 solver=None, row_perm: np.ndarray | None = None):
        self.A = sp.csc_matrix(A)
        self.sym = sym
        self.plan = plan
        self.Lx = Lx
        self.Ux = Ux
        self.config = config
        self._solver = solver      # the context's MegaSolver, if given
        self._solve_graphs = {}    # nrhs -> the device solve's graph
        # static pivot row permutation (Config.static_pivot): the factor is
        # of A[row_perm], so solves permute b on the way in; A is kept
        # unpermuted so refinement runs against the user's matrix
        self.row_perm = row_perm
        self._inperm = sym.perm if row_perm is None else row_perm[sym.perm]
        self._host = None

    def host_factors(self) -> tuple[np.ndarray, np.ndarray]:
        """(Lx, Ux) as contiguous numpy arrays (copied once)."""
        if self._host is None:
            self._host = tuple(np.ascontiguousarray(t.detach().cpu().numpy())
                               for t in (self.Lx, self.Ux))
        return self._host

    def _use_host_solve(self) -> bool:
        return use_host_solve(self.config)

    def _solve_host(self, b: np.ndarray) -> np.ndarray:
        """Native C++ supernodal solve on the copied-back factors (f64)."""
        from spfx_torch.symbolic import _native
        Lh, Uh = self.host_factors()
        n = self.sym.n
        squeeze = b.ndim == 1
        b2 = np.asarray(b, dtype=np.float64).reshape(n, -1)
        out = np.empty_like(b2)
        for j in range(b2.shape[1]):
            x = np.ascontiguousarray(b2[self._inperm, j])
            _native.lu_solve_host(self.sym, self.plan, Lh, Uh, x)
            out[self.sym.perm, j] = x
        return out[:, 0] if squeeze else out

    def _solve_device(self, b: np.ndarray) -> np.ndarray:
        """One forward (unit L) + backward (U, from U^T) supernodal solve
        pass on the device; the static pivot's rows permuted on the way
        in."""
        return device_solve(self, self.Lx, self.Ux, b)

    def solve(self, b: np.ndarray, refine: int | None = None) -> np.ndarray:
        """Solve A x = b with f64 (complex: complex128) iterative
        refinement (mixed precision)."""
        solve1 = self._solve_host if self._use_host_solve() \
            else self._solve_device
        return refined_solve(solve1, self.A, self.config, b, refine)

    def LU_sparse(self) -> tuple[sp.csc_matrix, sp.csc_matrix]:
        """Reconstruct (L, U) of P A P^T as scipy matrices — test path. The
        U^T panel holds U[c, r] where the L panel holds L[r, c]."""
        rows, cols, pos = lower_entries(self.sym, self.plan)
        Lh, Uh = self.host_factors()
        n = self.sym.n
        return (sp.csc_matrix((Lh[pos], (rows, cols)), shape=(n, n)),
                sp.csc_matrix((Uh[pos], (cols, rows)), shape=(n, n)))


class LU:
    """Reusable symbolic+plan context for same-pattern unsymmetric systems,
    factorized on one device."""

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
            if config.static_pivot:
                from spfx_torch.lu.pivot import static_pivot
                self.row_perm = static_pivot(A)
                A = self._pivot_rows(A)
            else:
                self.row_perm = None
            self.sym = sym if sym is not None else analyze(A, config,
                                                           symmetrize=True)
        self.analyze_time = span.seconds
        with instrument.timed("spfx.plan") as span:
            self.plan = build_plan(self.sym, A, config, lu=True)
            # over the user's pattern: the static pivot's rows folded in
            self._entry_map = EntryMap(
                self.A, lambda M: permuted_entries(
                    self.sym, self._pivot_rows(M), lu=True),
                self.device) if canonical else None
            span.set(**instrument.plan_attrs(self.plan, self.dtype, 2))
        self.plan_time = span.seconds
        check_windows(self.plan)
        self._runner = None
        self._solver = None

    def _pivot_rows(self, A: sp.csc_matrix) -> sp.csc_matrix:
        """A with the static pivot's rows permuted (A itself without)."""
        if self.row_perm is None:
            return A
        return sp.csc_matrix(A[self.row_perm])

    def entry_values(self, A: sp.spmatrix, permute_rows: bool = True):
        """Permuted L-lower and U^T strict-lower entry values — the only
        data that crosses the host->device link per factorization: through
        the context's ``EntryMap`` (the static pivot's rows folded in) when
        A has the analysed pattern, else the host pipeline (the static
        pivot's rows permuted inside ``spfx.entry.permute`` unless
        ``permute_rows`` is False), counted ``entry_fallback``."""
        A = sp.csc_matrix(A)
        out = None
        if self._entry_map is not None and permute_rows:
            out = self._entry_map(A, self.config.dtype)
        if out is None:
            instrument.count("entry_fallback")
            if permute_rows and self.row_perm is not None:
                with instrument.span("spfx.entry.permute"):
                    A = self._pivot_rows(A)
            out = entry_values(self.sym, A, self.config.dtype, self.device,
                               lu=True)
        return out

    def factorize(self, A: sp.spmatrix) -> LUFactor:
        with instrument.timed("spfx.factorize",
                              dtype=self.config.dtype) as req:
            A = sp.csc_matrix(A)
            vals_l, vals_u = self.entry_values(A)
            if self._runner is None:
                self._runner, self._solver = make_engine(self, lu=True)
            with instrument.profile_scope(self.config, "factorize"):
                if engine_of(self.config) == "calls":
                    Lx, Ux = self._runner.trace_fn()(vals_l, vals_u)
                else:
                    # graph replays on the card
                    Lx, Ux = self._runner.run(vals_l, vals_u)
            f = LUFactor(A, self.sym, self.plan, Lx, Ux, self.config,
                         solver=self._solver, row_perm=self.row_perm)
            return instrument.finish_factorize(self, f, req.start_s)


def lu(A: sp.spmatrix, config: Config = DEFAULT, device=None) -> LUFactor:
    """One-shot: analyze + plan + unpivoted numeric LU of A."""
    return LU(A, config, device=device).factorize(A)
