"""setup_analyze_s: seconds of the program's ``spfx.analyze`` span in the
set-up: the host's symbolic analysis (ordering, elimination tree,
supernodes; LU's static pivot where configured)."""

from portbench import recorder

SOURCE = "program_span"
LAYER = "host analysis and plan"
MOVES = "setup_s"


def read(obs):
    return recorder.setup_s(("spfx.analyze",))
