#!/usr/bin/env python
"""Align the pseudo-paths of two oriented reads and print the score
(reference: scripts/AlignPseudoPaths.py).

Usage: AlignPseudoPaths.py <runDir> <readId0> <strand0> <readId1> <strand1>
"""
import sys

from _common import open_run
from shasta_tpu_torch.graph.mode3 import create_mode3_graph
from shasta_tpu_torch.pipeline.iterative import score_alignment_pseudo_paths


def main(argv=None) -> int:
    a, args = open_run(argv)
    r0, s0, r1, s1 = (int(x) for x in args[1:5])
    m3 = create_mode3_graph(a.markers, a.marker_graph, min_link_coverage=1)
    j0 = m3.journey(2 * r0 + s0)
    j1 = m3.journey(2 * r1 + s1)
    print(f"Pseudo-path lengths: {j0.shape[0]}, {j1.shape[0]}")
    print("Journey 0:", " ".join(map(str, j0.tolist())))
    print("Journey 1:", " ".join(map(str, j1.tolist())))
    score = score_alignment_pseudo_paths(j0, j1)
    print(f"Pseudo-path alignment score: {score}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
