#!/usr/bin/env python
"""Flag inconsistent read graph alignments via triangle analysis
(reference: scripts/FlagInconsistentAlignments.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph.read_graph import flag_inconsistent_alignments


def main(argv=None) -> int:
    a, _ = open_run(argv)
    cr = a.config.read_graph
    n = flag_inconsistent_alignments(
        a.read_graph, a.alignments, a.reads.read_count,
        a.reads.is_chimeric,
        cr.flag_inconsistent_alignments_triangle_error_threshold,
        cr.flag_inconsistent_alignments_least_square_error_threshold,
        cr.flag_inconsistent_alignments_least_square_max_distance,
    )
    a.store.save_stage("ReadGraph", a.read_graph.arrays())
    print(f"Flagged {n} inconsistent read graph edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
