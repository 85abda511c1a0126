"""solve_ms: the window's time over the solve requests completed in it;
each is one ``factor.solve(B)`` of a block of right-hand sides, refined as
the configuration says."""

from portbench import stats

SOURCE = "host_clock"


def read(obs):
    if obs["mix"]["op"] != "solve":
        return None
    return stats.per_request_ms(obs["window_s"], obs["completed"])
