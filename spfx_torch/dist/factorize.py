"""Batch-sharded supernodal factorization over a process group.

Port of spfx/dist/factorize.py. Every rank holds the whole factor array,
replicated, and walks the plan's levels as the in-core walk does; at each
level and phase it takes its slice of every bucket's tasks, as JAX's
``shard_map`` over the buckets' dim 0 does (rank r gets tasks
[r * ceil(B / N), (r + 1) * ceil(B / N)); a rank with none skips the
bucket, where JAX pads with inert tasks). Its tasks read the replicated
factor and write into a zero delta array of the same layout (the update
phase subtracts its rows through the bucket's extend-add into the delta's
slab, the panel phase adds its panels' deltas into the delta's blocks);
then one ``all_reduce`` of the delta sums every rank's writes, and every
rank adds it to its factor (``lax.psum`` in JAX). One bucket's tasks
share one slab, so a rank's slice is a view of the bucket's cached device
tables, and the kernels of the in-core walk run unchanged
(``mega.update_step`` and ``mega.panel_step`` with a task range and a
target): the UT gathers, the extend-adds, the diagonal-block and
whole-panel kernels.

Two factor-sized all-reduces a level (LU: four) and the delta's zeroing
are the layout's known cost, as in the JAX package (its docstring); the
subtree engines (``spfx_torch.dist.subtree``) run this walk only over the
shared top of the elimination tree.

The ranks must order and plan alike: each analyzes and plans on its own
host, and a rank that loaded another planner (the native library against
the numpy fallback) orders the matrix otherwise. The engines all-gather a
digest of the permutation and of the plan's storage layout and raise on a
mismatch.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import scipy.sparse as sp
import torch

from spfx_torch.chol.factorize import (CholeskyFactor, _DTYPES, check_config,
                                       check_windows, entry_values)
from spfx_torch.dist.mesh import Mesh, all_gather_object, all_reduce_, \
    make_mesh
from spfx_torch.kernels import blocks, mega, route
from spfx_torch.kernels.mega import MegaSolver
from spfx_torch.lu.factorize import LUFactor
from spfx_torch.plan.schedule import build_plan
from spfx_torch.symbolic.analyze import analyze
from spfx_torch.utils.config import Config, DEFAULT


def task_range(B: int, size: int, rank: int) -> tuple:
    """(lo, hi): rank's tasks of a bucket of B under JAX's even split of B
    padded to a multiple of ``size`` (empty for a rank past the end)."""
    per = -(-B // size)
    lo = min(rank * per, B)
    return lo, min(lo + per, B)


def _merge(mesh: Mesh, arrays, deltas) -> None:
    """arrays += the sum of every rank's deltas (one all-reduce each)."""
    for a, d in zip(arrays, deltas):
        a += all_reduce_(mesh, d)


def sharded_walk(arrays, levels, lu: bool, config: Config, mesh: Mesh,
                 mode: str) -> None:
    """The level walk over ``levels``, in place on ``arrays`` ((L,) or
    (Lx, Ux), replicated on every rank), batch-sharded over the mesh: per
    level its update phase, then its panel phase, each this rank's tasks
    into a zero delta, one all-reduce, the sum added back."""
    dev, rank, size = mesh.device, mesh.rank, mesh.size
    upd_ctx = mega.update_precision(config)
    with mega.matmul_precision(config.matmul_precision):
        for lp in levels:
            if lp.updates:
                deltas = [torch.zeros_like(a) for a in arrays]
                with upd_ctx():
                    for ub in lp.updates:
                        lo, hi = task_range(len(ub.kw), size, rank)
                        if lo < hi:
                            mega.update_step(arrays, ub, dev, lu, out=deltas,
                                             tasks=(lo, hi))
                _merge(mesh, arrays, deltas)
            if lp.panels:
                deltas = [torch.zeros_like(a) for a in arrays]
                for pb in lp.panels:
                    lo, hi = task_range(len(pb.widths), size, rank)
                    if lo < hi:
                        mega.panel_step(arrays, pb, dev, lu, mode,
                                        out=deltas, tasks=(lo, hi))
                _merge(mesh, arrays, deltas)


def plan_digest(sym, plan, *extra) -> str:
    """A digest of the ordering and the storage layout of a plan (and of
    ``extra`` arrays): what every rank must agree on."""
    h = hashlib.sha256()
    for a in (sym.perm, plan.offsets, plan.strides, plan.below_shift,
              np.asarray([plan.storage]), *extra):
        if a is not None:
            h.update(np.ascontiguousarray(a, dtype=np.int64).tobytes())
    return h.hexdigest()


def check_same_plan(mesh: Mesh, digest: str) -> None:
    """Raise unless every rank's plan digest is this rank's."""
    got = all_gather_object(mesh, digest)
    if len(set(got)) != 1:
        bad = [r for r, d in enumerate(got) if d != digest]
        raise RuntimeError(
            f"rank {mesh.rank}: ranks {bad} ordered or planned the matrix "
            "otherwise (another planner: the native library against the "
            "numpy fallback?); build spfx_torch/_build/libspfxplanner.so "
            "before the ranks start")


def mesh_of(mesh: Mesh | None, axis: str | None, device) -> Mesh:
    """``mesh``, else the group's mesh (``make_mesh``) or, given
    ``device``, a one-device mesh on it."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        return mesh
    return make_mesh(axis or "d", devices=None if device is None
                     else [device])


class _ShardedBase:
    """Shared machinery: analyze, plan, check that every rank agrees, and
    run the batch-sharded walk over the whole plan."""

    lu = False

    def __init__(self, A: sp.spmatrix, config: Config = DEFAULT,
                 mesh: Mesh | None = None, axis: str | None = None,
                 sym=None, device=None):
        check_config(config)
        A = sp.csc_matrix(A)
        self.A = A
        self.config = config
        self.mesh = mesh_of(mesh, axis, device)
        self.axis = axis or self.mesh.axis_names[0]
        self.ndev = self.mesh.size
        self.device = self.mesh.device
        self.dtype = _DTYPES[config.dtype]
        t0 = time.perf_counter()
        self.sym = sym if sym is not None else analyze(
            A, config, symmetrize=self.lu)
        self.analyze_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.plan = build_plan(self.sym, A, config, lu=self.lu)
        self.plan_time = time.perf_counter() - t0
        check_windows(self.plan)
        check_same_plan(self.mesh, plan_digest(self.sym, self.plan))
        self._asm = None
        self._solver = None

    def _factor(self, A):
        """The factor arrays of A: assembly on the device from one upload
        of the entry values, then the sharded walk."""
        from spfx_torch.utils.instrument import profile_scope
        if self._asm is None:
            idx = (self.plan.assembly_idx, self.plan.assembly_idx_u) \
                if self.lu else (self.plan.assembly_idx,)
            self._asm = tuple(torch.as_tensor(i.astype(np.int64),
                                              device=self.device)
                              for i in idx)
            self._solver = MegaSolver(self.plan, lu=self.lu,
                                      config=self.config, device=self.device)
        vals = entry_values(self.sym, A, self.config.dtype, self.device,
                            self.lu)
        arrays = [blocks.assemble(a, v, self.plan.storage)
                  for a, v in zip(self._asm, vals)]
        with profile_scope(self.config, "factorize"):
            sharded_walk(arrays, self.plan.levels, self.lu, self.config,
                         self.mesh, route.panel_mode())
        return arrays


class ShardedCholesky(_ShardedBase):
    """Cholesky context whose numeric factorization is sharded over a mesh
    of ranks (one device each; the CUDA device unless ``device`` or
    ``mesh`` says otherwise). Usage mirrors ``spfx_torch.Cholesky``; the
    resulting ``CholeskyFactor`` is replicated on every rank, so its solves
    work unchanged."""

    lu = False

    def factorize(self, A: sp.spmatrix) -> CholeskyFactor:
        from spfx_torch.utils.instrument import finish_factorize
        A = sp.csc_matrix(A)
        t0 = time.perf_counter()
        (L,) = self._factor(A)
        f = CholeskyFactor(A, self.sym, self.plan, L, self.config,
                           solver=self._solver)
        return finish_factorize(self, f, t0)


class ShardedLU(_ShardedBase):
    """LU (no-pivot) context sharded over a mesh; mirrors
    ``spfx_torch.LU`` (as the JAX package's, without the static row
    pivot)."""

    lu = True

    def factorize(self, A: sp.spmatrix) -> LUFactor:
        from spfx_torch.utils.instrument import finish_factorize
        A = sp.csc_matrix(A)
        t0 = time.perf_counter()
        Lx, Ux = self._factor(A)
        f = LUFactor(A, self.sym, self.plan, Lx, Ux, self.config,
                     solver=self._solver)
        return finish_factorize(self, f, t0)
