#!/usr/bin/env python
"""Refine the read graph using pseudo-paths (one iterative-assembly
round) (reference: scripts/CreateReadGraphUsingPseudoPaths.py).

Usage: CreateReadGraphUsingPseudoPaths.py [runDir] [minScore]
"""
import sys

from _common import open_run
from shasta_tpu_torch.pipeline.iterative import refine_read_graph_with_pseudo_paths


def main(argv=None) -> int:
    a, args = open_run(argv)
    min_score = float(args[1]) if len(args) > 1 else 1.0
    kept, dropped = refine_read_graph_with_pseudo_paths(a, min_score=min_score)
    a.store.save_stage("ReadGraph", a.read_graph.arrays())
    print(f"Read graph rebuilt: kept {kept} alignments, dropped {dropped} "
          f"with discordant pseudo-paths.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
