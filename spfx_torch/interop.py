"""Carrying state between the JAX package and the port.

The flat factor plus the plan is this system's whole state: both packages
build the same plan from the same matrix and Config, so a factor computed
by one can be used by the other slot for slot. This module takes numpy
arrays only and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from spfx_torch.chol.factorize import Cholesky, CholeskyFactor
from spfx_torch.lu.factorize import LU, LUFactor

_BUCKET_TABLES = ("sns", "widths", "nbelow", "diag_start", "below_start",
                  "xcols", "xrows", "slab_lo", "kw", "mrows", "src_start",
                  "tgt_lrow", "tgt_cpos", "ea_idx", "ea_rbase", "ea_rel",
                  "ea_ng", "head_start", "rstart", "diag_row_start",
                  "below_row_start", "src_row_start", "tgt_row_start")
_BUCKET_STATICS = ("cp", "rbp", "mp", "kp", "csp", "slab_rows", "flops")
_PLAN_TABLES = ("assembly_idx", "assembly_idx_u", "offsets", "strides",
                "below_shift", "rows_sn")
_PLAN_STATICS = ("n", "xsize", "slack", "storage", "flops")


def _flat(ctx, flat, device) -> torch.Tensor:
    flat = np.asarray(flat)
    if flat.shape != (ctx.plan.storage,):
        raise ValueError(f"flat factor has shape {flat.shape}, the plan "
                         f"stores {ctx.plan.storage} values")
    dev = ctx.device if device is None else torch.device(device)
    return torch.tensor(np.asarray(flat, dtype=ctx.config.dtype), device=dev)


def factor_from_numpy(ctx: Cholesky, L_flat, device=None) -> CholeskyFactor:
    """A port factor of ``ctx``'s matrix from a flat factor array computed
    on the same plan (e.g. ``np.asarray(spfx_factor.L)``)."""
    return CholeskyFactor(ctx.A, ctx.sym, ctx.plan,
                          _flat(ctx, L_flat, device), ctx.config)


def lu_factor_from_numpy(ctx: LU, Lx_flat, Ux_flat, device=None) -> LUFactor:
    """A port LU factor of ``ctx``'s matrix from the twin flat arrays of a
    factor computed on the same plan (e.g. ``np.asarray(spfx_factor.Lx)``
    and ``np.asarray(spfx_factor.Ux)``)."""
    return LUFactor(ctx.A, ctx.sym, ctx.plan, _flat(ctx, Lx_flat, device),
                    _flat(ctx, Ux_flat, device), ctx.config,
                    row_perm=ctx.row_perm)


def plan_arrays(plan) -> dict:
    """Every table and static of a plan as numpy, keyed by name
    ("L<level>.U<i>.<field>" / "L<level>.P<i>.<field>" for buckets), so two
    plans can be compared table by table."""
    out = {}
    for name in _PLAN_STATICS:
        out[name] = np.asarray(getattr(plan, name))
    for name in _PLAN_TABLES:
        v = getattr(plan, name)
        if v is not None:
            out[name] = np.asarray(v)
    out["nlevels"] = np.asarray(len(plan.levels))
    for lv, lp in enumerate(plan.levels):
        for kind, bucket_list in (("U", lp.updates), ("P", lp.panels)):
            out[f"L{lv}.{kind}count"] = np.asarray(len(bucket_list))
            for i, b in enumerate(bucket_list):
                pre = f"L{lv}.{kind}{i}."
                out[pre + "type"] = np.asarray(type(b).__name__)
                for name in _BUCKET_TABLES + _BUCKET_STATICS:
                    v = getattr(b, name, None)
                    if v is not None:
                        out[pre + name] = np.asarray(v)
    return out


def als_tables_from_numpy(model, U, V):
    """Put a trained JAX ``ALSModel``'s tables (``np.asarray(m.U)``,
    ``np.asarray(m.V)``, padding rows included) into a port ``ALSModel``
    built on the same data and config; returns the model."""
    for name, new, old in (("U", U, model.U), ("V", V, model.V)):
        new = np.asarray(new)
        if new.shape != tuple(old.shape):
            raise ValueError(f"{name} has shape {new.shape}, the model's "
                             f"table is {tuple(old.shape)}")
        setattr(model, name, torch.tensor(new.astype(model.config.dtype),
                                          device=model.device))
    return model
