"""solve_pass_ms: host ms around each ``_solve_device`` call (permute,
copy in, the solve graph's replay, copy back), over the window's requests
outside the profiled slice."""

from portbench import stats

SOURCE = "program_span"
LAYER = "executor"
MOVES = "solve_ms"


def read(obs):
    return stats.mean(t * 1e3 for r in obs["records"]
                      if not r["profiled"] for t in r.get("pass_s", ()))
