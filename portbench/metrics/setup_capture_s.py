"""setup_capture_s: seconds of the program's graph captures in the set-up:
every ``spfx.capture`` (the factorization walk's eager warm-up and its
capture, per panel mode) and ``spfx.solve.capture`` (a solve graph's, per
right-hand-side count)."""

from portbench import recorder

SOURCE = "program_span"
LAYER = "executor"
MOVES = "setup_s"


def read(obs):
    return recorder.setup_s(("spfx.capture", "spfx.solve.capture"))
