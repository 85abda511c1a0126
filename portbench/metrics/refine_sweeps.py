"""refine_sweeps: the program's count of refinement sweeps (a correction
pass after the first solve) per solve request, over the window's requests
outside the profiled slice."""

from portbench import recorder, stats

SOURCE = "program_counter"
LAYER = "entry"
MOVES = "solve_ms"


def read(obs):
    reqs = recorder.requests(obs, "solve")
    if reqs is None:
        return None
    return stats.mean(r["counters"].get("refine_sweeps", 0) for r in reqs)
