"""A kernel's share of its roofline over a factorization: the least time
the card could take for the plan's calls of it (``bounds.path_bound_ms``)
over the traced device time of its launches per factorization."""

from __future__ import annotations

from portbench import bounds


def share(obs: dict, names, kernel: str):
    """The share in %, or None where the trace holds no launch whose name
    contains one of ``names``."""
    tr = obs.get("trace")
    if not tr or not tr.get("requests") or obs.get("plan") is None:
        return None
    secs = sum(v for n, v in tr["kernel_s"].items()
               if any(k in n for k in names))
    if secs <= 0:
        return None
    ms = secs / tr["requests"] * 1e3
    bound_ms = bounds.path_bound_ms(obs["plan"], kernel, obs["dtype"],
                                    obs["arrays"])
    return bound_ms / ms * 100.0
