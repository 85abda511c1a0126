"""solve_passes: calls of the factor's ``_solve_device`` (one forward and
backward pass on the device) per solve request: the first solve and each
refinement sweep."""

from portbench import stats

SOURCE = "program_counter"
LAYER = "entry"
MOVES = "solve_ms"


def read(obs):
    if obs["mix"]["op"] != "solve":
        return None
    return stats.mean(len(r.get("pass_s", ())) for r in obs["records"]
                      if not r["profiled"])
