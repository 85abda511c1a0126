"""factorize_ms: the window's time over the factorizations completed in
it; each is one ``ctx.factorize(A_k)``, from the call until the factor is
on the device, synchronized."""

from portbench import stats

SOURCE = "host_clock"


def read(obs):
    if obs["mix"]["op"] != "factorize":
        return None
    return stats.per_request_ms(obs["window_s"], obs["completed"])
