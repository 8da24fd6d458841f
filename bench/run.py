"""The benchmark of the port (``src/repro_torch``) on NVIDIA GPUs: one
run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload granite-3-2b-unscaled.train-4k \
        --seed 7 --seconds 51 --trace 0

Run from the root of a checkout.  Prints one JSON line last on standard
output; exits non-zero, printing no result, without the CUDA devices the
cell asks for.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
