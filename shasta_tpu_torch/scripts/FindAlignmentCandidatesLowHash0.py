#!/usr/bin/env python
"""LowHash0 candidate generation
(reference: scripts/FindAlignmentCandidatesLowHash0.py)."""
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.find_alignment_candidates()
    print(f"{a.candidates.count} alignment candidates.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
