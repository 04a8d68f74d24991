"""Run-length encoding of base sequences.

The reference stores reads in run-length representation: each maximal
run of the same base becomes a single base plus a repeat count
(reference: src/computeRunLengthRepresentation.cpp). Reads containing a
run longer than 255 are discarded by the loader.

The read store's encoder is the native library's (rle_fill_u8).
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


def rle_encode_store(
    codes: np.ndarray, offsets: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """RLE encode many sequences stored flat with CSR offsets, for the
    read store: returns (rle_bases uint8, repeat_counts uint8 clipped
    to 255, rle_offsets, bad_seq bool). Run boundaries never cross
    sequence boundaries.

    ``bad_seq[s]`` is True when sequence s contains a run longer than
    MAX_RUN_LENGTH (the loader discards those reads, so their clipped
    counts are never consumed). One native pass emits the uint8 counts
    directly, with no wide count arrays."""
    from shasta_tpu_torch import native

    return native.rle_encode_store_native(codes, offsets)


def rle_decode(rle_bases: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Expand run-length representation back to raw base codes."""
    return np.repeat(rle_bases, counts.astype(np.int64))
