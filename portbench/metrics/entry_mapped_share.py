"""entry_mapped_share: the share of factorizations whose entry values went
through the context's map built once (the program's counter
``entry_mapped``, one a mapped request; ``entry_fallback`` counts the
others), over the window's requests outside the profiled slice. A program
that counts neither (an older checkout) reports nothing."""

from portbench import recorder, stats

SOURCE = "program_counter"
LAYER = "entry"
MOVES = "factorize_ms"


def read(obs):
    reqs = recorder.requests(obs, "factorize")
    if reqs is None or not any(
            {"entry_mapped", "entry_fallback"} & set(r["counters"])
            for r in reqs):
        return None
    return stats.mean(r["counters"].get("entry_mapped", 0) for r in reqs)
