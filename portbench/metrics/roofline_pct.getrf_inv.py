"""roofline_pct.getrf_inv: the LU's diagonal blocks. The bound is
``bounds.getrf_work`` over the plan's blocks (the larger of bytes at 3.35
TB/s and flops at 67 TFLOP/s); the time is the traced device time of the
launches named below, per factorization."""

from portbench import roofline

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "factorize_ms"
KERNELS = ("getrf_inv_kernel",)


def read(obs):
    return roofline.share(obs, KERNELS, "getrf_inv")
