"""ut_step_ms: device ms of the latest graph replay inside its levels'
update buckets (UT: the gathers, the products, the extend-add and their
elementwise glue), summed over the levels, from the step stamps the
program captures in its factorization graph."""

from portbench import recorder

SOURCE = "program_span"
LAYER = "steps"
MOVES = "factorize_ms"


def read(obs):
    st = recorder.steps()
    return None if st is None else st["ut_ms"]
