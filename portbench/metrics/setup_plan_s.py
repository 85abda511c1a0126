"""setup_plan_s: seconds of the program's ``spfx.plan`` span in the
set-up: the static plan (levels, buckets and their tables) built on the
host from the analysis."""

from portbench import recorder

SOURCE = "program_span"
LAYER = "host analysis and plan"
MOVES = "setup_s"


def read(obs):
    return recorder.setup_s(("spfx.plan",))
