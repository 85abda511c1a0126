"""solve_kernel_share: the share of the device solve's bucket steps that
took the level-solve kernel (the program's counter
``solve_kernel_steps``; ``solve_chain_steps`` counts the steps that took
the torch chain), over the window's solve requests outside the profiled
slice. A program that counts neither (an older checkout) reports
nothing."""

from portbench import recorder

SOURCE = "program_counter"
LAYER = "executor"
MOVES = "solve_ms"


def read(obs):
    reqs = recorder.requests(obs, "solve")
    if reqs is None:
        return None
    kernel = sum(r["counters"].get("solve_kernel_steps", 0) for r in reqs)
    chain = sum(r["counters"].get("solve_chain_steps", 0) for r in reqs)
    if kernel + chain == 0:
        return None
    return kernel / (kernel + chain)
