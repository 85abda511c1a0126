"""entry_permute_ms: host ms of the program's ``spfx.entry.permute`` spans
(the permutation, the triangles, the CSC conversion and the cast, in
scipy; LU's static-pivot rows too) per factorization, over the window's
requests outside the profiled slice."""

from portbench import recorder, stats

SOURCE = "program_span"
LAYER = "entry"
MOVES = "factorize_ms"


def read(obs):
    reqs = recorder.requests(obs, "factorize")
    if reqs is None:
        return None
    return stats.mean(recorder.span_ms(r, "spfx.entry.permute")
                      for r in reqs)
