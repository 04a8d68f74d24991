#!/usr/bin/env python
"""Dump alignment candidates as CSV
(reference: scripts/WriteAlignmentCandidates.py)."""
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    print("ReadId0,ReadId1,SameStrand,Frequency")
    for i in range(a.candidates.count):
        print(f"{a.candidates.read_id0[i]},{a.candidates.read_id1[i]},"
              f"{int(a.candidates.same_strand[i])},{a.candidates.frequency[i]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
