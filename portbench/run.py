"""Run one cell of the port's benchmark (see portbench/README.md).

    python3 portbench/run.py --workload ls-unpaired --seed 7 \
        --seconds 45 --trace 0
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import core as harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
