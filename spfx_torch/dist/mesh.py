"""Device mesh and process group: the port of spfx/dist/mesh.py.

The JAX package runs one program over a ``jax.sharding.Mesh`` and lets
XLA place the collectives. The port runs one process per device over a
``torch.distributed`` process group: NCCL on the card, gloo across CPU
processes (what the tests run). ``init_distributed`` joins the group from
arguments or the JAX package's environment variables
(``SPFX_NUM_PROCESSES``, ``SPFX_COORDINATOR``, ``SPFX_PROCESS_ID``) and is
a no-op for one process; ``make_mesh`` is the 1-D mesh over the group's
ranks, one device a rank (this process's is ``mesh.device``), or over one
device when there is no group.

``shard_rows`` and ``replicated`` stand for the JAX package's two
``NamedSharding``s: a row-sharded table is held as this rank's block of
``round_up(n, size)`` rows and ``gather``ed back whole with one
all-gather; a replicated one is whole on every rank. ``all_reduce_`` is
the ``lax.psum`` of the sharded engines. Every collective the port makes
goes through this module and is counted on the host, by call and by
bytes (``collective_counts``), as the kernel wrappers count their
launches: a CUDA-graph replay of a captured collective does not count.
"""

from __future__ import annotations

import dataclasses
import os

import torch

_STATE: dict = {}           # "device": this process's device, once joined

# the collectives made since the last reset: calls and bytes sent in
_COUNTS = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0,
           "all_gather_bytes": 0}


def collective_counts() -> dict:
    """The collectives made since ``reset_collective_counts``: calls and
    bytes of this rank's operand, by kind."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def _dist():
    import torch.distributed as dist
    return dist


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     backend: str | None = None) -> None:
    """Join the process group from the arguments or the environment
    (``SPFX_NUM_PROCESSES``, ``SPFX_COORDINATOR`` as host:port or a
    ``tcp://`` / ``file://`` URL, ``SPFX_PROCESS_ID``); a no-op for one
    process. This rank's device is ``device``, else the CUDA device
    ``process_id % device_count`` (raises without one), and becomes the
    current CUDA device. The backend is NCCL for a CUDA device and gloo
    for the CPU, unless ``backend`` names one (gloo over CUDA tensors runs
    several ranks on one card, which NCCL refuses)."""
    if num_processes is None:
        num_processes = int(os.environ.get("SPFX_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    rank = process_id if process_id is not None \
        else int(os.environ.get("SPFX_PROCESS_ID", "0"))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass "
                               "device='cpu' to join over gloo")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    addr = coordinator or os.environ.get("SPFX_COORDINATOR",
                                         "localhost:9781")
    url = addr if "://" in addr else f"tcp://{addr}"
    _dist().init_process_group(backend, init_method=url,
                               world_size=num_processes, rank=rank)
    _STATE["device"] = device


def _world() -> tuple:
    """(size, rank) of the process group, (1, 0) without one."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one device per rank of ``group`` (``devices[r]`` is rank
    r's), or one device and no group. Collectives run over ``group``
    whenever there is one, a group of one rank included."""
    devices: tuple
    axis_names: tuple
    rank: int = 0
    group: object = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's device."""
        return self.devices[self.rank]


def make_mesh(axis: str = "data", devices=None) -> Mesh:
    """1-D mesh over the process group's ranks, or over one device.

    ``devices`` None: in a group, one device a rank (this rank's from
    ``init_distributed``, else the current CUDA device), gathered from
    every rank; without one, the CUDA device, as every entry point of the
    port. A list as long as the group names each rank's device. One
    device in a group of several, or one the group's backend cannot
    carry (the CPU under NCCL), is a mesh of this rank alone, with no
    collectives. A list longer than the group raises: the port drives one
    device per process, so a mesh of N devices needs N processes that
    each called ``init_distributed``."""
    from spfx_torch.chol.factorize import resolve_device
    world, rank = _world()
    if devices is None:
        own = _STATE.get("device") or resolve_device(None)
        if world == 1 and not _dist().is_initialized():
            return Mesh((own,), (axis,))
        devices = [None] * world
        _dist().all_gather_object(devices, str(own))
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) > world:
        raise NotImplementedError(
            f"a mesh of {len(devices)} devices in a process group of "
            f"{world}: the port drives one device per process; start "
            f"{len(devices)} processes and call init_distributed in each")
    carried = _dist().is_initialized() and (
        _dist().get_backend() != "nccl"
        or all(d.type == "cuda" for d in devices))
    if len(devices) == world and carried:
        return Mesh(devices, (axis,), rank, _dist().group.WORLD)
    if len(devices) == 1:
        return Mesh(devices, (axis,))
    raise ValueError(f"a mesh of {len(devices)} devices in a process group "
                     f"of {world}: a mesh takes every rank or one device")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def all_reduce_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the mesh's ranks, in place (complex through its real
    view); returns t. Without a group, t as it is."""
    if mesh.group is None:
        return t
    _COUNTS["all_reduce"] += 1
    _COUNTS["all_reduce_bytes"] += t.numel() * t.element_size()
    _dist().all_reduce(torch.view_as_real(t) if t.is_complex() else t,
                       group=mesh.group)
    return t


def all_gather_rows(mesh: Mesh, block: torch.Tensor) -> torch.Tensor:
    """Every rank's ``block`` stacked along dim 0 in rank order (one
    all-gather); without a group, ``block``."""
    if mesh.group is None:
        return block
    _COUNTS["all_gather"] += 1
    _COUNTS["all_gather_bytes"] += block.numel() * block.element_size()
    parts = [torch.empty_like(block) for _ in range(mesh.size)]
    _dist().all_gather(parts, block.contiguous(), group=mesh.group)
    return torch.cat(parts)


def all_gather_object(mesh: Mesh, obj) -> list:
    """Every rank's ``obj`` (picklable) in rank order; [obj] without a
    group. A host-side exchange, not counted."""
    if mesh.group is None:
        return [obj]
    out = [None] * mesh.size
    _dist().all_gather_object(out, obj, group=mesh.group)
    return out


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """A table row-sharded over the mesh (JAX: ``NamedSharding(mesh,
    P(axis))``): padded with zero rows to ``round_up(n, size)``, rank r
    holds rows [r * n / size, (r + 1) * n / size)."""
    mesh: Mesh

    def block(self, n: int) -> tuple:
        """(lo, hi): this rank's rows of an n-row table."""
        per = round_up(n, self.mesh.size) // self.mesh.size
        return self.mesh.rank * per, (self.mesh.rank + 1) * per

    def local(self, table: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole table (zero rows past its end)."""
        lo, hi = self.block(table.shape[0])
        blk = table[lo:hi]
        if blk.shape[0] < hi - lo:
            pad = table.new_zeros((hi - lo - blk.shape[0],) + table.shape[1:])
            blk = torch.cat([blk, pad])
        return blk

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole (padded) table from every rank's block."""
        return all_gather_rows(self.mesh, block)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """A table whole on every rank (JAX: ``NamedSharding(mesh, P())``)."""
    mesh: Mesh

    def local(self, table: torch.Tensor) -> torch.Tensor:
        return table

    def gather(self, table: torch.Tensor) -> torch.Tensor:
        return table


def shard_rows(mesh: Mesh, axis: str = "data") -> RowSharding:
    return RowSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)
