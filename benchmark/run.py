"""Run one cell of ``BENCHMARK.json`` once, on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``benchmark/README.md``).
Without a CUDA card, or with fewer cards than the cell asks for, it exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
