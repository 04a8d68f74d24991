#!/usr/bin/env python
"""Analyze assembly graph bubbles: branch read support and the
Bayesian relative-phase evidence for each informative bubble pair
(reference: scripts/AnalyzeAssemblyGraphBubbles.py)."""
import os
import sys

import numpy as np

from _common import open_run
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph
from shasta_tpu_torch.graph.mode2 import diploid_bayesian_phase, find_bubbles


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    bubbles = find_bubbles(ag, a.marker_graph)
    print(f"{len(bubbles)} bubbles.")
    out = os.path.join(a.run_dir, "AssemblyGraphBubblePairs.csv")
    n_pairs = 0
    with open(out, "w") as f:
        f.write("BubbleA,BubbleB,m00,m01,m10,m11,LogPin,LogPout\n")
        for i in range(len(bubbles)):
            for j in range(i + 1, len(bubbles)):
                bi, bj = bubbles[i], bubbles[j]
                m = np.array([
                    [np.intersect1d(bi.reads0, bj.reads0).shape[0],
                     np.intersect1d(bi.reads0, bj.reads1).shape[0]],
                    [np.intersect1d(bi.reads1, bj.reads0).shape[0],
                     np.intersect1d(bi.reads1, bj.reads1).shape[0]],
                ])
                if m.sum() < 1:
                    continue
                log_pin, log_pout = diploid_bayesian_phase(m, 0.1)
                f.write(f"{i},{j},{m[0,0]},{m[0,1]},{m[1,0]},{m[1,1]},"
                        f"{log_pin:.2f},{log_pout:.2f}\n")
                n_pairs += 1
    print(f"{n_pairs} informative bubble pairs. Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
