"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, this folder and
the program (`gemmul8_tpu_torch`). Needs one CUDA card of compute
capability 9.0; exits nonzero and prints no result without one.
"""

import time

T0 = time.time()   # the process's start, as near as Python gets

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, heads the import path
sys.path[0] = str(ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0, ROOT))
