#!/usr/bin/env python
"""Union-find stress test (reference: scripts/dset64Test.py +
src/dset64Test.cpp).

The reference stress-tests its lock-free 128-bit-CAS DisjointSets
against boost::disjoint_sets under multithreaded random unions. The
port's union-find is deterministic hooking + pointer jumping
(shasta_tpu_torch/graph/marker_graph.py:union_find_labels); this driver
verifies it against a serial path-compression oracle on random unions
and reports throughput.

Usage: dset64Test.py [n_items] [n_unions] [seed]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def serial_oracle(n, u, v):
    parent = list(range(n))

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for a, b in zip(u.tolist(), v.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    # Canonical labels: minimum member id per component.
    return np.fromiter((find(x) for x in range(n)), np.int64, n)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    n = int(argv[0]) if len(argv) > 0 else 1_000_000
    m = int(argv[1]) if len(argv) > 1 else 2_000_000
    seed = int(argv[2]) if len(argv) > 2 else 231

    from shasta_tpu_torch.graph.marker_graph import union_find_labels

    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)

    t0 = time.monotonic()
    labels = union_find_labels(n, u, v)
    dt = time.monotonic() - t0

    expected = serial_oracle(n, u, v)
    assert np.array_equal(labels, expected), "union-find labels mismatch"
    n_components = np.unique(labels).shape[0]
    print(f"dset64Test PASSED: {n} items, {m} unions, "
          f"{n_components} components, {m / dt / 1e6:.2f} M unions/s.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
