#!/usr/bin/env python
"""Flag chimeric reads (reference: scripts/FlagChimericReads.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph.read_graph import flag_chimeric_reads


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.reads.is_chimeric = flag_chimeric_reads(
        a.read_graph, a.reads.read_count,
        max_distance=a.config.read_graph.max_chimeric_read_distance,
    )
    a.store.save_stage("Reads", a.reads.arrays())
    print(f"Flagged {int(a.reads.is_chimeric.sum())} chimeric reads.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
