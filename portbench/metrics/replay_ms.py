"""replay_ms: device ms between CUDA events around the runner's ``run``
(copy-in, one graph replay, clone-out) per factorization, over the
window's requests outside the profiled slice."""

from portbench import stats

SOURCE = "program_span"
LAYER = "executor"
MOVES = "factorize_ms"


def read(obs):
    v = [r["replay_ms"] for r in obs["records"]
         if "replay_ms" in r and not r["profiled"]]
    return stats.mean(v)
