"""device_idle_pct.solve: the share of the profiled slice of the window
(from the first profiled request's start to the last one's end) in which
no operation runs on the device."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "solve_ms"


def read(obs):
    tr = obs.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
