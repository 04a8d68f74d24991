#!/usr/bin/env python
"""Align two oriented reads with the default banded method and print
the alignment (reference: scripts/AlignOrientedReads.py).

Usage: AlignOrientedReads.py <runDir> <readId0> <strand0> <readId1> <strand1>
"""
import sys

import numpy as np

from _common import open_run


def main(argv=None) -> int:
    a, args = open_run(argv)
    r0, s0, r1, s1 = (int(x) for x in args[1:5])
    from shasta_tpu_torch.ops.align import AlignParams, align_candidates

    same = s0 == s1
    lo, hi = (r0, r1) if r0 < r1 else (r1, r0)
    st = align_candidates(
        a.markers,
        np.array([lo], np.int32),
        np.array([hi], np.int32),
        np.array([same], bool),
        AlignParams(min_aligned_marker_count=0),
        a.kmer_table.downsampling_hash_table(),
        device=a.device,
    )
    if st.count == 0:
        print("No alignment found.")
    else:
        o0, o1 = st.ordinals(0)
        print(f"{o0.shape[0]} aligned markers.")
        for x, y in zip(o0.tolist(), o1.tolist()):
            print(x, y)
    return 0


if __name__ == "__main__":
    sys.exit(main())
