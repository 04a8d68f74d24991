#!/usr/bin/env python
"""Write groups of parallel marker graph edges (same source and
target) (reference: scripts/WriteParallelMarkerGraphEdges.py)."""
import os
import sys

import numpy as np

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    mg = a.marker_graph
    alive = np.flatnonzero(mg.alive())
    key = mg.source[alive] * np.int64(mg.vertex_count) + mg.target[alive]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    edge_s = alive[order]
    starts = np.concatenate(([0], np.flatnonzero(np.diff(key_s)) + 1, [key_s.shape[0]]))
    out = os.path.join(a.run_dir, "ParallelMarkerGraphEdges.csv")
    n_groups = 0
    with open(out, "w") as f:
        f.write("Source,Target,EdgeIds\n")
        for i in range(starts.shape[0] - 1):
            lo, hi = starts[i], starts[i + 1]
            if hi - lo < 2:
                continue
            es = edge_s[lo:hi]
            f.write(f"{mg.source[es[0]]},{mg.target[es[0]]},"
                    f"{' '.join(str(e) for e in es.tolist())}\n")
            n_groups += 1
    print(f"{n_groups} groups of parallel edges. Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
