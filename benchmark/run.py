"""Run one cell of the port's benchmark once:

    python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  See ``benchmark/README.md``.
"""

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    harness.set_cache_env()
    sys.exit(harness.main(sys.argv[1:], STARTED - harness.process_age()))
