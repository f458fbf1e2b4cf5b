"""The benchmark of firefoam_torch on one CUDA card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints, as the last line of standard
output, one JSON object: correct, attempted (the window's steps), failed,
metrics (--trace 0: the cell's end-to-end metrics; --trace 1: its
per-layer metrics), device, with --trace 1 a breakdown, and last the
numbers compared with their limits (also the last lines of standard
error). Exits non-zero, printing no result, without the CUDA cards the
cell asks for. See fbench/harness.py.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one process with one host thread for PyTorch's and numpy's CPU work: the
# host dispatches the step, so threads spinning beside it spread the runs
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from fbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
