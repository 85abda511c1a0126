"""Read the numbers that decide ``correct``, over many seeds in one
process, for the program and for its control; the limits in the
configurations' files were set from these readings.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--requests 6] [--out FILE]

For each seed the cell's inputs are drawn again on one context, the mix's
requests run ``--requests`` times (at least the sample a run judges), and
the sample is judged as a run judges it. The control is the program one
rung below the configuration's dtype on the precision ladder
(``reference.LADDER``): for float32 and complex64 its own TF32 path
(``matmul_precision="default"``), for float64 and complex128 the program
at float32 and complex64. One JSON line a reading, on standard output and
in ``--out``. Runs on the card only; the benchmark's own runs never run
it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench import reference, spec as specs
from portbench.run import merge


def readings(workload: str, seeds, requests: int, side: str, device,
             patch=None, roots=None, spec: dict | None = None):
    """Yield one dict a seed: the cell's checked numbers for ``side``
    ("program" or "control"). ``roots`` and ``spec`` are as
    ``portbench.run.main``'s."""
    spec = specs.load_spec() if spec is None else spec
    work, conf = specs.cell(spec, workload)
    with open(os.path.join(specs.ROOT, conf["file"])) as fh:
        config = json.load(fh)
    config = merge(config, patch or {})
    if side == "control":
        config = merge(config, reference.rung(config)["control"])
    mix = specs.load_json("traffic", work["traffic"], roots)
    driver = specs.load_module("drivers", config["driver"], roots)
    cell = None
    for seed in seeds:
        t0 = time.perf_counter()
        if cell is None:
            cell = driver.Cell(config, mix, seed, device, roots=roots)
            cell.setup()
        else:
            cell.reseed(seed)
        for i in range(max(requests, mix["sample"])):
            cell.request(i)
        yield dict(workload=workload, side=side, seed=seed,
                   requests=max(requests, mix["sample"]),
                   checks=cell.check(),
                   seconds=time.perf_counter() - t0)
    if cell is not None:
        cell.release()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    try:
        for side, seeds in (("program", args.seeds),
                            ("control", args.control_seeds)):
            seeds = [int(s) for s in seeds.split(",") if s]
            for r in readings(args.workload, seeds, args.requests, side,
                              dev):
                line = json.dumps(r)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
