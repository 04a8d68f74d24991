#!/usr/bin/env python
"""Exercise the Bayesian consensus caller on synthetic coverage
(reference: scripts/TestSimpleBayesianConsensusCaller.py).

Usage: TestSimpleBayesianConsensusCaller.py [modelNameOrCsvPath]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
import numpy as np

from shasta_tpu_torch.consensus.bayesian import BayesianConsensusCaller


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    caller = BayesianConsensusCaller(argv[0] if argv else "default")
    print(f"Model: {caller.model.name}")
    print("Coverage (base, repeat) x n -> called (base, repeat):")
    cases = [
        [(0, 3)] * 10,
        [(0, 3)] * 5 + [(0, 4)] * 5,
        [(2, 1)] * 3 + [(2, 2)] * 7,
        [(1, 6)] * 4 + [(1, 5)] * 4 + [(1, 7)] * 2,
    ]
    for cov in cases:
        bases = np.array([c[0] for c in cov], np.uint8)
        reps = np.array([c[1] for c in cov], np.int32)
        b, r = caller(bases, reps)
        print(f"  {cov} -> ({b}, {r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
