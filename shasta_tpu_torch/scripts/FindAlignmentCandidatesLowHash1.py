#!/usr/bin/env python
"""LowHash1 candidate generation with feature ordinals
(reference: scripts/FindAlignmentCandidatesLowHash1.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.ops import lowhash as LH


def main(argv=None) -> int:
    a, _ = open_run(argv)
    cm = a.config.min_hash
    params = LH.LowHashParams(
        m=cm.m,
        hash_fraction=cm.hash_fraction,
        iteration_count=cm.min_hash_iteration_count,
        log2_bucket_count=cm.log2_min_hash_bucket_count,
        min_bucket_size=cm.min_bucket_size,
        max_bucket_size=cm.max_bucket_size,
        min_frequency=cm.min_frequency,
    )
    res = LH.find_candidates_lowhash1(
        a.markers, params,
        a.reads.is_palindromic if a.reads is not None else None,
    )
    a.candidates = res.pairs
    a.store.save_stage("AlignmentCandidates", a.candidates.arrays())
    a.store.save_stage(
        "CandidateFeatureOrdinals",
        {"ord0": res.feature_ord0, "ord1": res.feature_ord1,
         "offsets": res.feature_offsets},
    )
    print(f"{a.candidates.count} alignment candidates with feature ordinals.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
