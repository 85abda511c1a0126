"""``BENCHMARK.json`` and the files the harness finds by name.

Every configuration, traffic mix, matrix family, driver and metric sits in
a file of its own, found by its name under one of the roots (this package's
folder unless a caller gives others first):

- ``traffic/<name>.json``: a mix's parameters;
- ``families/<name>.py``: a generator of the inputs of one kind of
  configuration (its ``Family``);
- ``drivers/<name>.py``: the requests of one kind of system (its
  ``Cell``);
- ``metrics/<name>.py``: one metric's reader, ``read(obs)``, which returns
  the value or None where it finds nothing to read.

A configuration's file is the ``file`` that ``BENCHMARK.json`` names.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPEC = os.path.join(ROOT, "BENCHMARK.json")

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def load_spec(path: str = SPEC) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find(kind: str, name: str, ext: str, roots=None) -> str:
    """The path of ``<root>/<kind>/<name><ext>`` under the first root that
    has it."""
    if not NAME.fullmatch(name):
        raise ValueError(f"{kind}: {name!r} is not a valid name")
    for root in (*(roots or ()), HERE):
        path = os.path.join(root, kind, name + ext)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no {kind}/{name}{ext} under {roots or HERE}")


def load_json(kind: str, name: str, roots=None) -> dict:
    with open(find(kind, name, ".json", roots)) as fh:
        return json.load(fh)


def load_module(kind: str, name: str, roots=None):
    """The module of ``<kind>/<name>.py``, loaded by its path (a metric's
    name may hold dots)."""
    path = find(kind, name, ".py", roots)
    key = f"portbench.{kind}.{name}@{path}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def cell(spec: dict, workload: str) -> tuple:
    """(workload entry, configuration entry) of ``workload``."""
    for w in spec["workloads"]:
        if w["name"] == workload:
            for c in spec["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise KeyError(f"configuration {w['config']!r} of {workload!r}")
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(spec: dict, section: str, workload: str) -> list:
    """The entries of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it; of those that list no cells, every
    end-to-end metric, and every per-layer metric whose end-to-end metric
    (``moves``) the cell reports."""
    e2e = {m["name"] for m in spec["end_to_end"]
           if workload in m.get("workloads", (workload,))}
    out = []
    for m in spec[section]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out
