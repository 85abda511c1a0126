"""entry_copy_ms: host ms of the program's ``spfx.entry.copy`` span (the
entry values' copy from pageable host memory to the device) per
factorization, over the window's requests outside the profiled slice."""

from portbench import recorder, stats

SOURCE = "program_span"
LAYER = "entry"
MOVES = "factorize_ms"


def read(obs):
    reqs = recorder.requests(obs, "factorize")
    if reqs is None:
        return None
    return stats.mean(recorder.span_ms(r, "spfx.entry.copy") for r in reqs)
