#!/usr/bin/env python
"""Dump every stored alignment's matched ordinal pairs to CSV
(reference: scripts/WriteAlignmentDetails.py).

Usage: WriteAlignmentDetails.py <runDir> [output.csv]
"""
import os
import sys

from _common import open_run


def main(argv=None) -> int:
    a, args = open_run(argv)
    out = args[1] if len(args) > 1 else os.path.join(a.run_dir, "AlignmentDetails.csv")
    al = a.alignments
    with open(out, "w") as f:
        f.write("AlignmentId,ReadId0,ReadId1,SameStrand,Ordinal0,Ordinal1\n")
        for i in range(al.count):
            lo, hi = al.offsets[i], al.offsets[i + 1]
            r0, r1, ss = al.read_id0[i], al.read_id1[i], int(al.same_strand[i])
            for o0, o1 in zip(al.ord0[lo:hi], al.ord1[lo:hi]):
                f.write(f"{i},{r0},{r1},{ss},{o0},{o1}\n")
    print(f"Wrote {al.count} alignments to {out}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
