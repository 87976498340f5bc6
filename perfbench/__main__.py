"""`python3 -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>`."""

import time

_T_START = time.perf_counter()

import sys  # noqa: E402

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=_T_START))
