"""The port's process group and mesh (spfx_torch.dist.mesh) on the CPU, and
the machinery that the multi-rank parity tests share: ``spawn`` starts one
process per rank, each of which imports a test module, calls its
``rank_main(world, rank, tmp)`` and leaves the group at a barrier;
``join`` puts a rank in a gloo group
whose rendezvous is a file under ``tmp`` (no port to collide between test
workers), with one torch thread; ranks write their results to ``tmp`` as
``.npz`` (``save``, ``load``).

This module and the modules whose ranks it starts import neither jax nor
the JAX package at import time (the parity tests import them inside the
functions that compute the JAX side), so the ranks run the port alone;
every rank records whether jax was loaded, and the tests hold that it
was not."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from spfx_torch.dist import mesh as dmesh
from spfx_torch.dist.mesh import init_distributed, make_mesh

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
RANK_TIMEOUT = 300          # seconds for a world's ranks to finish


def spawn(module: str, world: int, tmp, timeout: int = RANK_TIMEOUT):
    """Run ``module.rank_main(world, rank, tmp)`` in ``world`` fresh
    processes, one per rank, and wait for all; raise with the failing
    ranks' output. The port's planner library is built first, so every
    rank loads the same planner (a rank that built it itself could load
    another's half-written file and fall back to numpy ordering)."""
    from spfx_torch.cpp.build import build
    build(quiet=True)
    tmp = str(tmp)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [TESTS, ROOT, os.environ.get("PYTHONPATH", "")]))
    procs = []
    for rank in range(world):
        # every rank waits for the others at the end, so none leaves the
        # group while another still talks to it
        code = (f"import {module} as m, torch.distributed as d; "
                f"m.rank_main({world}, {rank}, {tmp!r}); "
                "d.barrier(); d.destroy_process_group()")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs, bad = [], []
    for rank, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        if p.returncode != 0:
            bad.append(rank)
    if bad:
        raise AssertionError(
            f"{module} world {world}: ranks {bad} failed\n"
            + "\n".join(f"--- rank {r} ---\n{outs[r][-3000:]}" for r in bad))
    return tmp


def join(world: int, rank: int, tmp: str):
    """Join the gloo group of ``world`` CPU ranks that meet at ``tmp``;
    returns the group's mesh."""
    torch.set_num_threads(1)
    init_distributed(coordinator="file://" + os.path.join(tmp, "rdv"),
                     num_processes=world, process_id=rank, device="cpu")
    return make_mesh("d")


def save(tmp: str, name: str, rank: int, **arrays) -> None:
    """Write one case's arrays of one rank (``jax_loaded`` added)."""
    np.savez(os.path.join(tmp, f"{name}.r{rank}.npz"),
             jax_loaded=np.asarray("jax" in sys.modules), **arrays)


def load(tmp: str, name: str, rank: int = 0) -> dict:
    with np.load(os.path.join(tmp, f"{name}.r{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def rank_main(world: int, rank: int, tmp: str) -> None:
    """Each rank: its mesh's size, rank and device, the device list every
    rank sees, a one-device mesh of itself, and the refusals."""
    mesh = join(world, rank, tmp)
    out = dict(size=mesh.size, rank=mesh.rank, device=str(mesh.device),
               devices=[str(d) for d in mesh.devices],
               group=mesh.group is not None)
    one = make_mesh(devices=["cpu"])
    out["one"] = [one.size, one.group is None]
    for n, kind in ((world + 1, NotImplementedError), (world - 1, ValueError)):
        if n < 2:
            continue
        try:
            make_mesh(devices=["cpu"] * n)
            out[f"mesh{n}"] = "made"
        except kind as e:
            out[f"mesh{n}"] = str(e)
    x = torch.full((3,), float(rank + 1), dtype=torch.float64)
    out["sum"] = dmesh.all_reduce_(mesh, x).tolist()
    out["counts"] = dmesh.collective_counts()
    with open(os.path.join(tmp, f"mesh.r{rank}.json"), "w") as f:
        json.dump(dict(out, jax_loaded="jax" in sys.modules), f)


@pytest.fixture(scope="module", params=[2, 3])
def meshes(request, tmp_path_factory):
    world = request.param
    tmp = spawn("test_torch_ranks", world, tmp_path_factory.mktemp(
        f"mesh{world}"))
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"mesh.r{r}.json")) as f:
            outs.append(json.load(f))
    return world, outs


def test_mesh_of_the_group(meshes):
    """make_mesh in a group of 2 and 3: one device a rank, every rank's
    list the same; a one-device mesh has no group; all_reduce_ sums and
    counts; no rank loaded jax."""
    world, outs = meshes
    for r, o in enumerate(outs):
        assert (o["size"], o["rank"], o["device"], o["group"]) \
            == (world, r, "cpu", True)
        assert o["devices"] == ["cpu"] * world
        assert o["one"] == [1, True]
        assert o["sum"] == [world * (world + 1) / 2] * 3
        assert o["counts"] == dict(all_reduce=1, all_reduce_bytes=24,
                                   all_gather=0, all_gather_bytes=0)
        assert not o["jax_loaded"]


def test_mesh_larger_than_the_group_raises(meshes):
    world, outs = meshes
    for o in outs:
        assert "init_distributed" in o[f"mesh{world + 1}"]
        if world > 2:
            assert "every rank or one device" in o[f"mesh{world - 1}"]


def test_init_distributed_alone_is_a_no_op(monkeypatch):
    monkeypatch.delenv("SPFX_NUM_PROCESSES", raising=False)
    init_distributed()
    init_distributed(num_processes=1, device="cpu")
    assert not dist.is_initialized()
    mesh = make_mesh(devices=["cpu"])
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    t = torch.ones(2)
    assert dmesh.all_reduce_(mesh, t) is t


def test_init_distributed_needs_a_device(monkeypatch):
    """Without CUDA and without device="cpu" it raises: no silent gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed(num_processes=2, process_id=0)
    assert not dist.is_initialized()


def test_row_sharding_blocks():
    """A one-device mesh's row sharding is the whole table; the blocks of
    a mesh of 3 cover round_up(n, 3) rows, padded with zeros."""
    one = dmesh.shard_rows(make_mesh(devices=["cpu"]))
    t = torch.arange(10.0).reshape(5, 2)
    assert torch.equal(one.local(t), t) and torch.equal(one.gather(t), t)
    assert dmesh.replicated(make_mesh(devices=["cpu"])).local(t) is t
    three = [dmesh.RowSharding(dmesh.Mesh(("cpu",) * 3, ("d",), r))
             for r in range(3)]
    blocks = [s.local(t) for s in three]
    assert [s.block(5) for s in three] == [(0, 2), (2, 4), (4, 6)]
    assert torch.equal(torch.cat(blocks)[:5], t)
    assert not blocks[2][1:].any()
