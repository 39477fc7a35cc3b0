"""The benchmark of the PyTorch and CUDA port (tf_operator_tpu_torch).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json once on the card, from the root of a
checkout: builds the port's kernels (cached in the checkout), makes the
weights and inputs from the seed on the card, warms up the cell's
shapes, measures a window of --seconds, checks what the timed path
produced against the plain reference, and prints one JSON line.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout, not portbench/, is where imports resolve: the port and
# the portbench package
sys.path[0] = str(ROOT)

from portbench.harness.core import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(root=ROOT, t_start=T0))
