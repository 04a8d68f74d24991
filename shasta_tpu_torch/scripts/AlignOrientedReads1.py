#!/usr/bin/env python
"""Align two oriented reads with method 1 (full unbanded marker NW)
and print the aligned ordinal pairs
(reference: scripts/AlignOrientedReads1.py).

Usage: AlignOrientedReads1.py <runDir> <readId0> <strand0> <readId1> <strand1>
"""
import sys

from _common import open_run
from shasta_tpu_torch.ops.align_other import align_method1


def main(argv=None) -> int:
    a, args = open_run(argv)
    r0, s0, r1, s1 = (int(x) for x in args[1:5])
    k0, _ = a.markers.get(2 * r0 + s0)
    k1, _ = a.markers.get(2 * r1 + s1)
    o0, o1 = align_method1(k0, k1)
    print(f"{o0.shape[0]} aligned markers.")
    for x, y in zip(o0.tolist(), o1.tolist()):
        print(x, y)
    return 0


if __name__ == "__main__":
    sys.exit(main())
