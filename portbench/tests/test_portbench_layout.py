"""The harness is driven by data: a cell, a traffic mix and a metric added
as new files and BENCHMARK.json entries run without an edit to any file
that is there."""

import copy
import json

from portbench import spec as specs

FIXTURE_METRIC = '''"""A fixture: the number of requests in the window."""

SOURCE = "program_counter"
LAYER = "entry"
MOVES = "factorize_ms"


def read(obs):
    return float(obs["completed"]) if obs["completed"] else None
'''


def test_new_mix_and_metric_from_a_directory(tmp_path, run_cell):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "traffic" / "refactor_fixture.json").write_text(json.dumps(
        {"op": "factorize", "pool": 3, "warm": 1, "sample": 2,
         "profile_requests": 1}))
    (tmp_path / "metrics" / "fixture.requests.py").write_text(
        FIXTURE_METRIC)
    spec = copy.deepcopy(specs.load_spec())
    cell = "poisson3d-48-chol-f32.refactor_fixture"
    spec["workloads"].append({"name": cell, "config":
                              "poisson3d-48-chol-f32", "traffic":
                              "refactor_fixture", "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        if m["name"] == "factorize_ms":
            m["workloads"].append(cell)
    spec["per_layer"].append({"name": "fixture.requests", "unit": "1",
                              "better": "higher",
                              "source": "program_counter", "layer": "entry",
                              "moves": "factorize_ms",
                              "workloads": [cell]})
    roots = [str(tmp_path)]
    rc, line = run_cell(cell, trace=1, roots=roots, spec=spec)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["fixture.requests"]["value"] == line["attempted"]
    rc, line = run_cell(cell, trace=0, roots=roots, spec=spec)
    assert set(line["metrics"]) == {"factorize_ms", "setup_s"}


def test_metrics_without_cells_follow_what_they_move():
    spec = copy.deepcopy(specs.load_spec())
    spec["per_layer"].append({"name": "x", "unit": "1", "better": "lower",
                              "source": "program_counter", "layer": "entry",
                              "moves": "solve_ms"})
    on = {w["name"] for w in spec["workloads"]
          if "x" in [m["name"] for m in specs.metrics_of(spec, "per_layer",
                                                         w["name"])]}
    assert on == {w["name"] for w in spec["workloads"]
                  if w["traffic"] == "solve16"}
