#!/usr/bin/env python
"""Align two oriented reads with method 4
(reference: scripts/AlignOrientedReads4.py).

Usage: AlignOrientedReads4.py <runDir> <readId0> <strand0> <readId1> <strand1>
"""
import sys

import numpy as np

from _common import open_run


def main(argv=None) -> int:
    a, args = open_run(argv)
    r0, s0, r1, s1 = (int(x) for x in args[1:5])
    from shasta_tpu_torch.ops.align import AlignParams
    from shasta_tpu_torch.ops.align_other import align_candidates_method4

    same = s0 == s1
    lo, hi = (r0, r1) if r0 < r1 else (r1, r0)
    st = align_candidates_method4(
        a.markers,
        np.array([lo], np.int32),
        np.array([hi], np.int32),
        np.array([same], bool),
        AlignParams(min_aligned_marker_count=0),
        device=a.device,
    )
    if st.count == 0:
        print("No alignment found.")
    else:
        o0, o1 = st.ordinals(0)
        print(f"{o0.shape[0]} aligned markers.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
