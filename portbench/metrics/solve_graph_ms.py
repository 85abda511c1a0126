"""solve_graph_ms: device ms of the solve graph's replay per pass, between
the CUDA events the program records around it (``spfx.solve.graph``), over
the window's solve requests outside the profiled slice."""

from portbench import recorder, stats

SOURCE = "program_span"
LAYER = "executor"
MOVES = "solve_ms"


def read(obs):
    reqs = recorder.requests(obs, "solve")
    if reqs is None:
        return None
    return stats.mean(d["ms"] for r in reqs for d in r["device"]
                      if d["name"] == "spfx.solve.graph")
