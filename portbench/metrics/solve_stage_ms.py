"""solve_stage_ms: host ms of a pass's staging (``spfx.solve.stage_in``:
the permutation, the cast and the copy to the device;
``spfx.solve.stage_out``: the copy back and the permutation), per pass,
over the window's solve requests outside the profiled slice."""

from portbench import recorder

SOURCE = "program_span"
LAYER = "entry"
MOVES = "solve_ms"


def read(obs):
    reqs = recorder.requests(obs, "solve")
    if reqs is None:
        return None
    passes = sum(recorder.spans(r, "spfx.solve.pass") for r in reqs)
    staged = sum(recorder.span_ms(r, "spfx.solve.stage_in")
                 + recorder.span_ms(r, "spfx.solve.stage_out") for r in reqs)
    return staged / passes if passes else None
