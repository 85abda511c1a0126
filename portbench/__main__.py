"""``python -m portbench``: see ``portbench.run``."""

import time

T0 = time.perf_counter()    # set-up is timed from here, the process start

import sys  # noqa: E402

from portbench.run import main  # noqa: E402

sys.exit(main(sys.argv[1:], t0=T0))
