"""spfx_torch — the PyTorch/CUDA port of spfx (supernodal sparse Cholesky
and no-pivot LU).

The JAX package ``spfx`` is the reference; this package imports nothing of
it. The host layers (ordering, symbolic analysis, the static plan, the
native planner) are kept as copies, so both packages build the same plan
and the same flat factor layout. The device work runs on an NVIDIA GPU
through hand-written CUDA kernels (``spfx_torch.kernels``), or on the CPU
through their plain PyTorch versions when the caller passes
``device="cpu"``.

Public API:
    spfx_torch.cholesky(A)          -> CholeskyFactor (solve/L_sparse/logdet)
    spfx_torch.Cholesky(A)          -> reusable symbolic+plan context
    spfx_torch.lu(A) / spfx_torch.LU(A) -> unpivoted sparse LU
    spfx_torch.analyze(A)           -> Symbolic
    spfx_torch.Config               -> runtime configuration
    spfx_torch.validate(factor)     -> (x, scaled_residual)
"""

from spfx_torch.utils.config import Config, DEFAULT
from spfx_torch.symbolic.analyze import analyze, Symbolic
from spfx_torch.chol.factorize import cholesky, Cholesky, CholeskyFactor
from spfx_torch.lu.factorize import lu, LU, LUFactor
from spfx_torch.validate import validate, scaled_residual, synth_rhs

__all__ = [
    "Config", "DEFAULT", "analyze", "Symbolic",
    "cholesky", "Cholesky", "CholeskyFactor",
    "lu", "LU", "LUFactor",
    "validate", "scaled_residual", "synth_rhs",
]

__version__ = "0.1.0"
