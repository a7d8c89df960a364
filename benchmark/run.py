"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(or ``python -m benchmark.run ...``) from the root of a checkout, on a
machine with as many CUDA cards as the cell asks for.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number the correctness check
compared with its limit.  See :mod:`benchmark.harness`.
"""

import time

T0 = time.perf_counter()   # set-up is timed from here

import os  # noqa: E402
import os.path as osp  # noqa: E402
import sys  # noqa: E402

# one thread a library pool: the process's own threads (the loaders'
# workers, the prefetchers, the launching thread) share a few cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

# the checkout's root in place of this script's folder, whose modules
# would otherwise shadow top-level names
sys.path[0] = osp.dirname(osp.dirname(osp.abspath(__file__)))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
