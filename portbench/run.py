"""
Run one cell of the benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program ``lkpy_tpu_torch``.  The last line of standard output is
the result, one JSON object; the set-up's parts and the card's name and
power limit come on earlier lines, and the numbers compared, each beside
its limit, are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    # one process with few threads: the host's thread pools stay out of the way
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    build = ROOT / "build"
    # every build and kernel cache at a fixed place inside the checkout
    os.environ["LKT_CACHE_DIR"] = str(build / "lkpy_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    from portbench.core.cli import main

    sys.exit(main(sys.argv[1:], T_START))
