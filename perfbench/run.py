"""The benchmark of shasta_tpu_torch on an NVIDIA H100: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. See ``harness.py`` for what a run does
and ``PERF.md`` for the cells, metrics and limits.
"""

import time

T_PROCESS = time.monotonic()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_threads(argv):
    """The ``host_threads`` of the configuration of the cell that
    ``--workload`` names, or None."""
    try:
        name = argv[argv.index("--workload") + 1]
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            spec = json.load(f)
        w = next(w for w in spec["workloads"] if w["name"] == name)
        c = next(c for c in spec["configs"] if c["name"] == w["config"])
        with open(os.path.join(ROOT, c["file"])) as f:
            return json.load(f).get("host_threads")
    except (ValueError, IndexError, OSError, StopIteration, KeyError):
        return None


# The program's OpenMP and BLAS pools (numpy's and torch's CPU threads) at
# the configuration's size, set before they start; its native code keeps
# its own threads.
_threads = host_threads(sys.argv[1:])
if _threads:
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[_var] = str(_threads)

sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
