"""roofline_pct.potrf_inv: the Cholesky's diagonal blocks. The bound is
``bounds.potrf_work`` over the plan's blocks (the larger of bytes at 3.35
TB/s and flops at 67 TFLOP/s); the time is the traced device time of the
launches named below, per factorization."""

from portbench import roofline

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "factorize_ms"
KERNELS = ("potrf_inv_kernel",)


def read(obs):
    return roofline.share(obs, KERNELS, "potrf_inv")
