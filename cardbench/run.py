"""One run of one cell of the benchmark, on the card.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the numbers compared by the check on standard error, then the
result as one JSON line on standard output. Exits with another code than
0, and prints no result, without as many CUDA devices as the cell asks
for, or if JAX or flac_tpu was loaded.
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cardbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], START))
