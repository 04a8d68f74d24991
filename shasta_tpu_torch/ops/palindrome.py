"""Palindromic read detection.

Counterpart of shasta_tpu/ops/palindrome.py and of the reference
flagPalindromicReads
(reference: src/AssemblerAlign.cpp:652-780): align each read against
its own reverse complement in marker space; the read is palindromic if
the aligned fraction and the fraction of matches near the main
diagonal (|ordinal0 - ordinal1| < deltaThreshold) both exceed their
thresholds.

Deviation from the reference: the reference uses the unbanded method-0
alignment; here the self-RC alignment runs the banded DP kernel with
the band centered on the diagonal (±deltaThreshold). A palindromic
read's self-RC alignment lies near the diagonal by construction, so
the banded alignment captures the same signal; matches outside the
band would be discarded by the near-diagonal criterion anyway.
"""

from __future__ import annotations

import numpy as np

from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.ops.align import AlignParams, _CsrStreamingRunner


def flag_palindromic_reads(
    markers: MarkerStore,
    aligned_fraction_threshold: float = 0.1,
    near_diagonal_fraction_threshold: float = 0.1,
    delta_threshold: int = 100,
    device="cuda",
) -> np.ndarray:
    """Returns is_palindromic: bool [n_reads]. The self-RC alignments
    run on ``device`` ("cuda": the CUDA kernels; "cpu": the plain
    version)."""
    n_or = markers.oriented_read_count
    n_reads = n_or // 2
    out = np.zeros(n_reads, dtype=bool)
    if n_reads == 0:
        return out

    koff = markers.offsets
    kmer_flat = markers.kmer_ids.astype(np.int32)

    # Pre-filter: the NEAR-DIAGONAL match count of the self-RC DP is
    # bounded above by the multiset intersection of (k-mer,
    # diagonal-bucket) keys between the read and its RC. A DP match
    # (i, j) with |i - j| < delta pairs strand-0 ordinal i with RC
    # ordinal j; bucketing ordinals by delta and inserting each RC
    # element into its bucket and both neighbours guarantees every
    # near-diagonal match lands in a shared bucket, while random
    # k-mer collisions (which made a plain multiset-intersection
    # bound useless at k=10, where the RLE k-mer space is only
    # 4*3^(k-1)) are cut by a factor of ~3*delta/n. Any read whose
    # bound is below near_diagonal_fraction_threshold cannot be
    # flagged and needs no alignment. (The reference instead aligns
    # every read, src/AssemblerAlign.cpp:652.)
    counts = np.diff(koff)
    counts0 = counts[0::2]
    n_pos0 = int(counts0.sum())
    d = max(1, int(delta_threshold))
    max_bucket = int(counts0.max()) // d + 2 if n_pos0 else 1
    bucket_bits = int(max_bucket).bit_length() + 1
    KH_BITS = 22  # k-mer hash width; collisions only loosen the bound
    read_bits = 63 - KH_BITS - bucket_bits
    if n_pos0 and n_reads < (1 << read_bits):
        SH_B = 1 + KH_BITS
        SH_R = 1 + KH_BITS + bucket_bits
        from shasta_tpu_torch import native

        cum0_full = np.zeros(n_reads + 1, np.int64)
        np.cumsum(counts0, out=cum0_full[1:])
        both = native.palindrome_keys_native(
            markers.kmer_ids, koff, cum0_full, n_reads, markers.k, d,
            max_bucket, KH_BITS, SH_B, SH_R, n_pos0,
        )
        both.sort()
        common = native.palindrome_scan_native(both, SH_R, n_reads)
        frac_cap = np.where(counts0 > 0, common / np.maximum(counts0, 1), 0.0)
        candidates = np.flatnonzero(
            frac_cap >= near_diagonal_fraction_threshold
        )
    elif n_pos0:
        # Key layout overflow (astronomically many reads): align all.
        candidates = np.flatnonzero(counts0 > 0)
    else:
        candidates = np.zeros(0, dtype=np.int64)
    if candidates.shape[0] == 0:
        return out

    # Both sides of the self-RC alignment are rows of the oriented-read
    # marker CSR ((r, 0) vs (r, 1)), so the batches are built on the
    # device by the same gather as candidate alignment.
    W = 2 * delta_threshold
    band_mins = np.full(candidates.shape[0], -delta_threshold, dtype=np.int64)
    widths = np.full(candidates.shape[0], W, dtype=np.int64)
    params = AlignParams()
    runner = _CsrStreamingRunner(kmer_flat, koff, counts, params, device)
    runner.add_many(
        2 * candidates, 2 * candidates + 1, band_mins, widths, candidates
    )
    runner.flush_all()
    d = int(delta_threshold)
    for tags, met, rows, cols, vals in runner.collect_flat():
        total = counts0[tags].astype(np.int64)
        mcount = met[:, 0]
        near = np.bincount(
            rows,
            weights=(np.abs(cols - vals) < d).astype(np.float64),
            minlength=tags.shape[0],
        ).astype(np.int64)
        ok = (
            (total > 0)
            & (mcount > 0)
            & (mcount / np.maximum(total, 1) >= aligned_fraction_threshold)
            & (near / np.maximum(total, 1) >= near_diagonal_fraction_threshold)
        )
        out[tags[ok]] = True
    return out
