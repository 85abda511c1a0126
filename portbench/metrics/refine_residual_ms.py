"""refine_residual_ms: host ms of the float64 refinement's residuals
(``spfx.refine.residual``: b - A x and its norm) per solve request, over
the window's requests outside the profiled slice."""

from portbench import recorder, stats

SOURCE = "program_span"
LAYER = "entry"
MOVES = "solve_ms"


def read(obs):
    reqs = recorder.requests(obs, "solve")
    if reqs is None:
        return None
    return stats.mean(recorder.span_ms(r, "spfx.refine.residual")
                      for r in reqs)
