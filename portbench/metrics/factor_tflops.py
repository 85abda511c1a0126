"""factor_tflops: the plan's operations over the device time of the latest
graph replay's steps, in TFLOP/s. The operations are the ``flops``
attribute of the cell's ``spfx.plan`` set-up span (one factorization's
work, whatever its arithmetic); the time is the sum of the step intervals
the program captures in its factorization graph (the assembly, every UT
step and every PC step). A rate in one unit of work for the float32 and
float64 walks alike, not a share of a peak: it names no peak."""

from portbench import recorder

SOURCE = "program_span"
LAYER = "steps"
MOVES = "factorize_ms"


def read(obs):
    if obs["mix"]["op"] != "factorize":
        return None
    snap = recorder.snapshot()
    if snap is None:
        return None
    plans = [s for s in snap["setup"] if s["name"] == "spfx.plan"]
    flops = plans[-1]["attrs"].get("flops") if plans else None
    st = recorder.steps()
    if flops is None or st is None:
        return None
    ms = st["assembly_ms"] + st["ut_ms"] + st["pc_ms"]
    return flops / ms / 1e9 if ms > 0 else None
