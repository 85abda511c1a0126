"""setup_s: from the process's start to the window's first request: the
imports, the inputs, the host analysis and plan, building the kernels (the
first run in a checkout), the warm requests and their graph captures."""

SOURCE = "host_clock"


def read(obs):
    return obs["setup_s"]
