#!/usr/bin/env python
"""Re-run alignment computation against a persisted run
(reference: scripts/ComputeAlignments.py)."""
import sys
from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.compute_alignments()
    print(f"Computed {a.alignments.count} alignments.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
