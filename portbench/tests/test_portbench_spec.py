"""BENCHMARK.json against the benchmark's contract, and the files it names
against it."""

import json
import os
import re

import pytest

from portbench import spec as specs

SPEC = specs.load_spec()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(SPEC) == KEYS
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.fullmatch(w) for w in cmd)
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(specs.SPEC) <= 64 * 1024


def every_name():
    yield from (c["name"] for c in SPEC["configs"])
    for w in SPEC["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for s in ("end_to_end", "per_layer")
                for m in SPEC[s])
    for c in SPEC["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(every_name())))
def test_names_use_allowed_characters(name):
    assert NAME.fullmatch(name), name


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_entries(section):
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if section == "end_to_end" else {"layer", "moves"})
    names = [m["name"] for m in SPEC[section]]
    assert len(names) == len(set(names))
    for m in SPEC[section]:
        assert set(m) - {"workloads"} == keys, m["name"]
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0 < m["bound"] <= 0.25
            assert m["name"] != "setup_s" or m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert LINE.fullmatch(m["layer"])


def test_workloads_and_configs():
    cnames = [c["name"] for c in SPEC["configs"]]
    assert len(cnames) == len(set(cnames)) and 1 <= len(cnames) <= 24
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        with open(os.path.join(specs.ROOT, c["file"])) as fh:
            conf = json.load(fh)
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert set(conf["limits"]) and all(
            v > 0 for v in conf["limits"].values())
    pairs = set()
    used = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.fullmatch(w["why"])
        assert w["config"] in cnames
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        specs.load_json("traffic", w["traffic"])
    assert used == set(cnames)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_what_it_must(workload):
    e2e = {m["name"] for m in specs.metrics_of(SPEC, "end_to_end",
                                               workload)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert specs.metrics_of(SPEC, "per_layer", workload)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_per_layer_cells_report_what_they_move(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    assert m["moves"] in {x["name"] for x in SPEC["end_to_end"]}
    for w in m.get("workloads", ()):
        reported = {x["name"] for x in specs.metrics_of(SPEC, "end_to_end",
                                                        w)}
        assert m["moves"] in reported, (metric, w)


def test_layer_names_are_consistent():
    layers = {}
    for m in SPEC["per_layer"]:
        mod = specs.load_module("metrics", m["name"])
        assert (mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["source"], m["layer"], m["moves"]), m["name"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]])
def test_end_to_end_readers(metric):
    mod = specs.load_module("metrics", metric)
    m = next(x for x in SPEC["end_to_end"] if x["name"] == metric)
    assert mod.SOURCE == m["source"]


def test_roofline_names():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].startswith("roofline_pct.")
            assert m["unit"] == "%" and m["better"] == "higher"
            assert m["source"] == "device_trace"
            assert specs.load_module("metrics", m["name"]).KERNELS
