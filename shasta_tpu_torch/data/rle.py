"""Run-length encoding of base sequences.

The reference stores reads in run-length representation: each maximal
run of the same base becomes a single base plus a repeat count
(reference: src/computeRunLengthRepresentation.cpp). Reads containing a
run longer than 255 are discarded by the loader.

These are fully vectorized numpy transforms over flat arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

MAX_RUN_LENGTH = 255


def rle_encode(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Run-length encode one sequence of base codes.

    Returns (rle_bases uint8, repeat_counts int32). Counts are NOT
    clipped here; the caller decides what to do with runs > 255.
    """
    n = codes.shape[0]
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int32)
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(codes[1:], codes[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    counts = np.diff(np.append(starts, n)).astype(np.int32)
    return codes[starts].astype(np.uint8), counts


def rle_encode_flat(
    codes: np.ndarray, offsets: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run-length encode many sequences stored flat with CSR offsets.

    ``codes`` is the concatenation of all sequences; ``offsets`` has
    length n_seq+1. Run boundaries never cross sequence boundaries.

    Returns (rle_bases, repeat_counts int32, rle_offsets).
    """
    n = codes.shape[0]
    n_seq = offsets.shape[0] - 1
    if n == 0:
        return (
            np.zeros(0, np.uint8),
            np.zeros(0, np.int32),
            np.zeros(n_seq + 1, np.int64),
        )
    if n >= 1 << 20:
        # Native single-pass encoder (equality-tested in test_native).
        from shasta_tpu_torch import native

        out = native.rle_encode_native(codes, offsets)
        if out is not None:
            rle, counts, rle_offsets = out
            return rle, counts.astype(np.int32), rle_offsets
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(codes[1:], codes[:-1], out=change[1:])
    # Every sequence start is a run start (handles equal bases across
    # adjacent sequences in the flat layout).
    inner_starts = offsets[:-1]
    change[inner_starts[inner_starts < n]] = True
    starts = np.flatnonzero(change)
    counts = np.diff(np.append(starts, n)).astype(np.int32)
    # Per-sequence number of runs -> offsets.
    seq_of_start = np.searchsorted(offsets, starts, side="right") - 1
    runs_per_seq = np.bincount(seq_of_start, minlength=n_seq)
    rle_offsets = np.zeros(n_seq + 1, dtype=np.int64)
    np.cumsum(runs_per_seq, out=rle_offsets[1:])
    return codes[starts].astype(np.uint8), counts, rle_offsets


def rle_encode_store(
    codes: np.ndarray, offsets: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """RLE encode for the read store: returns (rle_bases uint8,
    repeat_counts uint8 clipped to 255, rle_offsets, bad_seq bool).

    ``bad_seq[s]`` is True when sequence s contains a run longer than
    MAX_RUN_LENGTH (the loader discards those reads, so their clipped
    counts are never consumed). The native path emits uint8 counts
    directly, skipping the int64 -> int32 -> uint8 conversion chain
    that dominated addReads at genome scale."""
    n = codes.shape[0]
    n_seq = offsets.shape[0] - 1
    if n >= 1 << 20:
        from shasta_tpu_torch import native

        out = native.rle_encode_store_native(codes, offsets)
        if out is not None:
            return out
    rle_bases, counts, rle_offsets = rle_encode_flat(codes, offsets)
    long_run = counts > MAX_RUN_LENGTH
    bad_seq = np.zeros(n_seq, dtype=bool)
    if long_run.any():
        run_seq = (
            np.searchsorted(rle_offsets, np.flatnonzero(long_run), side="right")
            - 1
        )
        bad_seq[np.unique(run_seq)] = True
    return (
        rle_bases,
        np.minimum(counts, MAX_RUN_LENGTH).astype(np.uint8),
        rle_offsets,
        bad_seq,
    )


def rle_decode(rle_bases: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Expand run-length representation back to raw base codes."""
    return np.repeat(rle_bases, counts.astype(np.int64))
