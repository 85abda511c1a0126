"""factorize_p90_ms: the 90th percentile (nearest rank) of the wall times
of every factorization of the window."""

from portbench import stats

SOURCE = "host_clock"


def read(obs):
    if obs["mix"]["op"] != "factorize" or not obs["request_s"]:
        return None
    return stats.p90(obs["request_s"]) * 1e3
