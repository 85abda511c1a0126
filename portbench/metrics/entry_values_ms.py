"""entry_values_ms: host ms of the context's ``entry_values`` (permute,
triangles, one copy to the device) per factorization, over the window's
requests outside the profiled slice."""

from portbench import stats

SOURCE = "program_span"
LAYER = "entry"
MOVES = "factorize_ms"


def read(obs):
    v = [r["entry_values_s"] * 1e3 for r in obs["records"]
         if "entry_values_s" in r and not r["profiled"]]
    return stats.mean(v)
