"""Which kernel family factors a PC panel bucket: the ``SPFX_PANEL_KERNEL``
switch.

Port of ``route_panel`` and the width limits of spfx/kernels/vmem.py. The
variable takes the JAX package's values:

- unset, ``auto`` or ``blocked``: the NB = 32 blocked path around
  ``panel.potrf_inv`` / ``panel.getrf_inv`` (the default);
- ``lanes``: the whole-panel kernels of ``panel_lanes`` (batch in the last
  dimension);
- ``wide``: the whole-panel kernels of ``panel_wide`` (task-major, blocked
  by 32 columns);
- ``mixed``: ``lanes`` wherever it applies, ``blocked`` elsewhere.

Both whole-panel families cover panel widths cp <= 256. Two differences
from the JAX route, both because the port has no TPU to model:

- the JAX route also refuses a class whose modeled VMEM stack is too large
  (``lanes_panel_bytes`` / ``wide_panel_bytes`` against ``CAP_ROUTE``); the
  port has no such model, so every class with cp <= 256 takes the kernel;
- where the JAX route answers ``xla`` (a forced family on a class wider
  than 256), the port answers ``blocked``: it has no XLA expander path.

A complex class always answers ``blocked``, whatever the mode: the
whole-panel kernels take float32 and float64 only, and the JAX package
routes complex panels away from its Pallas kernels as well
(``_chol_deltas_blocks`` / ``_lu_deltas_blocks`` in spfx/kernels/blocks.py).

Any other value of the variable raises.

``SPFX_NO_PALLAS`` is not ported, by design. In the JAX package it sends
every Pallas call to its XLA fallback; its one user is ``bench.py``'s retry
after a kernel fails to compile on the TPU. Here the kernels are built
ahead with nvcc, so there is no compile failure to retry around, and on
the card every wrapper launches its kernel or raises: a switch to the
plain versions would be the fallback the port does not have.
"""

from __future__ import annotations

import os

LANES_CP_MAX = 256            # lanes kernels cover panel widths up to this
WIDE_CP_MAX = 256             # wide kernels cover panel widths up to this

ENV = "SPFX_PANEL_KERNEL"
MODES = ("auto", "blocked", "lanes", "wide", "mixed")


def panel_mode() -> str:
    """The panel-kernel mode from ``SPFX_PANEL_KERNEL``: 'blocked',
    'lanes', 'wide' or 'mixed' (unset and 'auto' give 'blocked'); raises
    ValueError on any other value."""
    v = os.environ.get(ENV, "")
    if v not in ("",) + MODES:
        raise ValueError(f"{ENV}={v!r}: expected one of "
                         f"{', '.join(MODES)} (or unset)")
    return "blocked" if v in ("", "auto") else v


def route_panel(cp: int, rbp: int, B: int, itemsize: int = 4,
                lu: bool = False, mode: str | None = None,
                cplx: bool = False) -> str:
    """'blocked' | 'lanes' | 'wide' for a (cp, rbp, B) panel class under
    ``mode`` (read from the environment when None); always 'blocked' for
    a complex class (``cplx``). ``rbp``, ``B``, ``itemsize`` and ``lu``
    sized the JAX route's VMEM model and do not change the port's
    answer."""
    mode = panel_mode() if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"panel mode {mode!r}: expected one of "
                         f"{', '.join(MODES)}")
    if cplx:
        return "blocked"
    if mode in ("lanes", "mixed") and cp <= LANES_CP_MAX:
        return "lanes"
    if mode == "wide" and cp <= WIDE_CP_MAX:
        return "wide"
    return "blocked"
