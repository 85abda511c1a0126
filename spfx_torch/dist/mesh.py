"""Device mesh: the part of spfx/dist/mesh.py that the recommender uses.

The JAX package lays its embedding tables row-sharded over a 1-D
``jax.sharding.Mesh`` (``make_mesh``, ``round_up``). The port's mesh is
one process on one device: the device list and the axis name. A mesh of
more than one device raises until the multi-device engines are ported
(ROADMAP Queue 1 item 9), which bring ``init_distributed``, ``shard_rows``
and ``replicated`` with ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: its devices and its one axis name."""
    devices: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(axis: str = "data", devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: the CUDA device, as every entry
    point of the port). More than one device raises."""
    if devices is None:
        from spfx_torch.chol.factorize import resolve_device
        devices = [resolve_device(None)]
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != 1:
        raise NotImplementedError(
            f"a mesh of {len(devices)} devices: the port runs on one device "
            "until the multi-device engines are ported (ROADMAP Queue 1 "
            "item 9)")
    return Mesh(devices, (axis,))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
