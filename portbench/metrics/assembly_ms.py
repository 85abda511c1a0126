"""assembly_ms: device ms of the latest graph replay between its first two
step stamps (the scatter of the entry values into fresh storage), from the
timing events the program captures in its factorization graph."""

from portbench import recorder

SOURCE = "program_span"
LAYER = "steps"
MOVES = "factorize_ms"


def read(obs):
    st = recorder.steps()
    return None if st is None else st["assembly_ms"]
