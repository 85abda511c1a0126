"""iALS training benchmark: examples/s + retrieval quality.

Port of spfx/bench/als_bench.py. The harness

- loads real MovieLens files if SPFX_ML_PATH points at one (u.data /
  ratings.csv), else generates synthetic interactions with planted
  low-rank structure at the shape SPFX_ALS_SCALE names ("100k", the
  default: 943 users, 1,682 items; "20m": 138,000 users, 27,000 items,
  average degree 144), cached as ``spfx_als_<scale>.npz`` in the temporary
  directory;
- reports sustained examples/s over full ALS iterations, timed by the
  slope between ``fit_steps(1)`` and ``fit_steps(1 + iters)`` around
  ``torch.cuda.synchronize`` (each call replays one captured iteration
  with no host wait), and recall@20 / NDCG@10 on a leave-5-out split;
- prints the card's name and power limit (nvidia-smi) on a line of its
  own, then one JSON line with the JAX bench's keys.

Run: python -m spfx_torch.bench.als_bench   (on the CUDA device; N ranks:
one process each with SPFX_NUM_PROCESSES=N, SPFX_PROCESS_ID=r and
SPFX_COORDINATOR=host:port, which also reports ``scaling()``)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from spfx_torch.dist.mesh import init_distributed, make_mesh
from spfx_torch.recsys import data as rdata
from spfx_torch.recsys.als import ALSModel, ALSConfig

# the bench's model: rank 64, caps 256 / 512, 512-row chunks, float32
BENCH_CONFIG = ALSConfig(rank=64, lam=0.3, alpha=10.0, user_cap=256,
                         item_cap=512, chunk=512, dtype="float32")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def interactions(scale: str) -> rdata.Interactions:
    """SPFX_ML_PATH's MovieLens file, else the synthetic ``scale`` shape
    (from the cache when there is one)."""
    path = os.environ.get("SPFX_ML_PATH")
    if path and os.path.exists(path):
        inter = rdata.load_movielens(path)
        log(f"loaded {path}: {inter.num_users} users {inter.num_items} items "
            f"{inter.nnz} interactions")
        return inter
    cache = os.path.join(tempfile.gettempdir(), f"spfx_als_{scale}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        inter = rdata.Interactions(int(z["nu"]), int(z["ni"]),
                                   z["u"], z["i"], z["r"])
    else:
        if scale == "20m":
            inter = rdata.synthetic(138000, 27000, avg_degree=144,
                                    rank=16, seed=0)
        else:
            inter = rdata.synthetic(943, 1682, avg_degree=106, rank=12,
                                    seed=0)
        np.savez(cache, nu=inter.num_users, ni=inter.num_items,
                 u=inter.user_ids, i=inter.item_ids, r=inter.ratings)
    log(f"synthetic {scale}: {inter.num_users} users {inter.num_items} "
        f"items {inter.nnz} interactions")
    return inter


def slope(m: ALSModel, iters: int) -> tuple[float, dict]:
    """Seconds per iteration: (t(fit_steps(1 + iters)) - t(fit_steps(1)))
    / iters, host clock around ``torch.cuda.synchronize``, after one
    warm-up call (the capture). Returns it and the two times."""
    m.fit_steps(1)                     # warm-up and capture
    m._sync()
    t = {}
    for r in (1, 1 + iters):
        t0 = time.perf_counter()
        m.fit_steps(r)
        m._sync()
        t[r] = time.perf_counter() - t0
        log(f"fit_steps({r}): {t[r]:.3f}s")
    return max(t[1 + iters] - t[1], 1e-9) / iters, t


def run(scale: str = "100k", iters: int = 8, mesh=None) -> dict:
    inter = interactions(scale)
    train, test = inter.split(holdout=5, seed=1)
    m = ALSModel(train, BENCH_CONFIG, mesh=mesh)
    per_iter, _ = slope(m, iters)
    steady = [train.nnz * 2 / per_iter]
    log(f"slope per-iteration: {per_iter:.3f}s  {steady[0]:,.0f} examples/s")
    metrics = m.evaluate(test)
    out = {
        "examples_per_sec": float(np.median(steady)),
        **{k: v for k, v in metrics.items()},
        "nnz": train.nnz,
        "devices": m.mesh.size,
    }
    log(json.dumps(out))
    return out


def scaling(scale: str = "100k", device=None) -> dict:
    """examples/s of this rank alone (a one-device mesh) against the
    process group's mesh of every rank, on the same problem; on one rank
    the efficiency is 1.0. Every rank of the group calls it. ``device``:
    this rank's, when not the group's or the CUDA device."""
    full_mesh = make_mesh(devices=None if device is None else [device])
    one = run(scale, mesh=make_mesh(devices=[full_mesh.device]), iters=4)
    if full_mesh.size == 1:
        return {"scaling_efficiency": 1.0, "single": one}
    full = run(scale, mesh=full_mesh, iters=4)
    eff = full["examples_per_sec"] / (one["examples_per_sec"]
                                      * full_mesh.size)
    out = {"scaling_efficiency": eff, "single": one, "full": full}
    log(json.dumps({"scaling_efficiency": eff}))
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("als_bench: no CUDA device")
    init_distributed()
    print(card_line(), flush=True)
    print(json.dumps(run(scale=os.environ.get("SPFX_ALS_SCALE", "100k"))),
          flush=True)
    if make_mesh().size > 1:
        scaling(os.environ.get("SPFX_ALS_SCALE", "100k"))
