"""roofline_pct.window_gather2: the UT steps' superwindow gathers. The
bound is the plan's gather bytes (``bounds.gather_bytes`` over every UT
step, once per factor array) at 3.35 TB/s; the time is the traced device
time of the launches named below, per factorization."""

from portbench import roofline

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "factorize_ms"
KERNELS = ("window_gather_kernel",)


def read(obs):
    return roofline.share(obs, KERNELS, "window_gather2")
