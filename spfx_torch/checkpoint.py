"""Factor checkpoints: save a computed factor with its symbolic structure,
and load it back without factoring again.

Port of spfx/checkpoint.py, with the same ``.npz`` keys: a factor saved by
either package loads in the other. The loader rebuilds the plan from the
stored symbolic structure (host work only) and checks that its layout is
the stored one.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_factor(path: str, factor) -> None:
    """Save a CholeskyFactor or LUFactor to ``path`` (.npz)."""
    sym = factor.sym
    plan = factor.plan
    data = dict(
        kind=np.array("lu" if hasattr(factor, "Ux") else "chol"),
        n=np.int64(sym.n), perm=sym.perm, parent=sym.parent,
        counts=sym.counts, sn_start=sym.sn_start, sn_of=sym.sn_of,
        sn_ptr=sym.sn_ptr, sn_rows=sym.sn_rows, sn_level=sym.sn_level,
        offsets=plan.offsets, strides=plan.strides,
        xsize=np.int64(plan.xsize),
        A_indptr=factor.A.indptr, A_indices=factor.A.indices,
        A_data=factor.A.data,
        dtype=np.array(factor.config.dtype),
    )
    if hasattr(factor, "Ux"):
        data["Lx"] = _host(factor.Lx)
        data["Ux"] = _host(factor.Ux)
        if getattr(factor, "row_perm", None) is not None:
            data["row_perm"] = factor.row_perm
    else:
        data["L"] = _host(factor.L)
    np.savez_compressed(path, **data)


def load_factor(path: str, config=None, device=None):
    """Restore a factor saved with ``save_factor`` onto ``device`` (the
    CUDA device unless given). Rebuilds the solve plan from the stored
    symbolic structure and reattaches the stored factor values; raises
    ValueError when the plan's layout is not the stored one."""
    import torch

    from spfx_torch.chol.factorize import resolve_device
    from spfx_torch.plan.schedule import build_plan
    from spfx_torch.symbolic.analyze import Symbolic
    from spfx_torch.utils.config import Config

    dev = resolve_device(device)
    z = np.load(path, allow_pickle=False)
    kind = str(z["kind"])
    n = int(z["n"])
    sym = Symbolic(
        n=n, perm=z["perm"], parent=z["parent"], counts=z["counts"],
        sn_start=z["sn_start"], sn_of=z["sn_of"], sn_ptr=z["sn_ptr"],
        sn_rows=z["sn_rows"], sn_level=z["sn_level"],
        nnzL=int(z["counts"].sum()),
        flops=float((z["counts"].astype(float) ** 2).sum()))
    A = sp.csc_matrix((z["A_data"], z["A_indices"], z["A_indptr"]),
                      shape=(n, n))
    config = config or Config(dtype=str(z["dtype"]))
    row_perm = z["row_perm"] if "row_perm" in z.files else None
    Aplan = A if row_perm is None else sp.csc_matrix(A[row_perm])
    plan = build_plan(sym, Aplan, config, lu=(kind == "lu"))
    if plan.xsize != int(z["xsize"]):
        raise ValueError("stored factor layout does not match this config "
                         f"(xsize {z['xsize']} vs {plan.xsize}); save/load "
                         "must use the same bucketing/stride settings")

    def tensor(key):
        return torch.tensor(z[key], device=dev)

    if kind == "lu":
        from spfx_torch.lu.factorize import LUFactor
        return LUFactor(A, sym, plan, tensor("Lx"), tensor("Ux"), config,
                        row_perm=row_perm)
    from spfx_torch.chol.factorize import CholeskyFactor
    return CholeskyFactor(A, sym, plan, tensor("L"), config)
