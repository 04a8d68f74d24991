"""The read store: run-length-encoded reads as flat arrays + CSR offsets.

Counterpart of the reference's Reads class
(reference: src/Reads.hpp:263-285), which keeps RLE sequences,
per-base repeat counts, read names and per-read flags in memory-mapped
containers. Here everything is a dense numpy array (device-transferable
as needed):

- ``rle_bases``   uint8  [total_rle]  2-bit base codes of the RLE sequence
- ``repeat_counts`` uint8 [total_rle] run length per RLE base
- ``offsets``     int64  [n_reads+1]  CSR offsets into the two above
- ``raw_lengths`` int64  [n_reads]    raw (non-RLE) read lengths
- flags: ``is_palindromic``, ``is_chimeric`` bool [n_reads]

Strand-1 (reverse complement) sequences are derived on the fly:
rc(rle)[i] = 3 - rle[L-1-i], counts reversed.

Filtering semantics follow the reference ReadLoader
(reference: src/ReadLoader.cpp, src/AssemblerReads.cpp:15): discard
reads shorter than minReadLength (raw bases), containing invalid bases,
or containing a homopolymer run longer than 255.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from shasta_tpu_torch.data import bases as B
from shasta_tpu_torch.data import rle as R
from shasta_tpu_torch.io.fasta import ParsedReads


@dataclass
class DiscardCounts:
    """Counters mirroring the reference AssemblerInfo discard counters
    (reference: src/Assembler.hpp:115-132)."""

    short_read_count: int = 0
    short_read_base_count: int = 0
    bad_base_read_count: int = 0
    bad_base_read_base_count: int = 0
    long_run_read_count: int = 0
    long_run_read_base_count: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


@dataclass
class ReadStore:
    rle_bases: np.ndarray  # uint8 [total_rle]
    repeat_counts: np.ndarray  # uint8 [total_rle]
    offsets: np.ndarray  # int64 [n_reads+1]
    raw_lengths: np.ndarray  # int64 [n_reads]
    names: List[str] = field(default_factory=list)
    metadata: List[str] = field(default_factory=list)
    is_palindromic: Optional[np.ndarray] = None  # bool [n_reads]
    is_chimeric: Optional[np.ndarray] = None  # bool [n_reads]
    discards: DiscardCounts = field(default_factory=DiscardCounts)
    # 1 = RLE (default); 0 = raw: ``rle_bases`` holds the raw sequence
    # and ``repeat_counts`` is all ones, so every downstream consumer
    # (markers, consensus, RLE->raw expansion) works unchanged
    # (reference: src/Reads.hpp representation flag, set by the
    # Nanopore-Phased configs).
    representation: int = 1

    def __post_init__(self):
        n = self.read_count
        if self.is_palindromic is None:
            self.is_palindromic = np.zeros(n, dtype=bool)
        if self.is_chimeric is None:
            self.is_chimeric = np.zeros(n, dtype=bool)

    @property
    def read_count(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def total_rle_bases(self) -> int:
        return int(self.offsets[-1])

    @property
    def total_raw_bases(self) -> int:
        return int(self.raw_lengths.sum())

    def rle_length(self, read_id: int) -> int:
        return int(self.offsets[read_id + 1] - self.offsets[read_id])

    def rle_lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def read_rle(self, read_id: int, strand: int = 0) -> np.ndarray:
        s = self.rle_bases[self.offsets[read_id] : self.offsets[read_id + 1]]
        if strand == 0:
            return s
        return B.reverse_complement(s)

    def read_repeat_counts(self, read_id: int, strand: int = 0) -> np.ndarray:
        c = self.repeat_counts[self.offsets[read_id] : self.offsets[read_id + 1]]
        if strand == 0:
            return c
        return c[::-1].copy()

    def read_raw(self, read_id: int, strand: int = 0) -> np.ndarray:
        return R.rle_decode(
            self.read_rle(read_id, strand), self.read_repeat_counts(read_id, strand)
        )

    def arrays(self) -> Dict[str, np.ndarray]:
        """Named arrays for the stage manifest (checkpoint)."""
        return {
            "rle_bases": self.rle_bases,
            "repeat_counts": self.repeat_counts,
            "offsets": self.offsets,
            "raw_lengths": self.raw_lengths,
            "is_palindromic": self.is_palindromic,
            "is_chimeric": self.is_chimeric,
            "names": np.array(self.names, dtype=np.str_),
            "metadata": np.array(
                self.metadata if self.metadata else [""] * self.read_count,
                dtype=np.str_,
            ),
            "representation": np.array([self.representation], np.int64),
        }

    @classmethod
    def from_arrays(cls, a: Dict[str, np.ndarray]) -> "ReadStore":
        return cls(
            rle_bases=a["rle_bases"],
            repeat_counts=a["repeat_counts"],
            offsets=a["offsets"],
            raw_lengths=a["raw_lengths"],
            names=list(a["names"]),
            metadata=list(a["metadata"]),
            is_palindromic=a["is_palindromic"].copy(),
            is_chimeric=a["is_chimeric"].copy(),
            representation=(
                int(a["representation"][0]) if "representation" in a else 1
            ),
        )


def build_read_store(
    parsed: ParsedReads,
    min_read_length: int = 0,
    representation: int = 1,
) -> ReadStore:
    """Encode, filter, and (for representation=1) RLE-compress parsed
    reads (vectorized). representation=0 stores the raw sequence with
    unit repeat counts (reference: src/Reads.hpp raw mode)."""
    if representation not in (0, 1):
        raise ValueError(f"Reads.representation must be 0 or 1, got {representation}")
    codes = (
        parsed.codes
        if getattr(parsed, "codes", None) is not None
        else B.encode_ascii(parsed.seq_ascii)
    )
    offsets = parsed.offsets
    n = parsed.read_count
    raw_lengths = np.diff(offsets)

    discards = DiscardCounts()

    # Reads with invalid bases.
    invalid = codes == B.INVALID_BASE
    if invalid.any():
        seq_ids = np.searchsorted(offsets, np.flatnonzero(invalid), side="right") - 1
        bad_base = np.zeros(n, dtype=bool)
        bad_base[np.unique(seq_ids)] = True
    else:
        bad_base = np.zeros(n, dtype=bool)

    short = raw_lengths < min_read_length

    discards.short_read_count = int(short.sum())
    discards.short_read_base_count = int(raw_lengths[short].sum())
    bad_only = bad_base & ~short
    discards.bad_base_read_count = int(bad_only.sum())
    discards.bad_base_read_base_count = int(raw_lengths[bad_only].sum())

    keep = ~(short | bad_base)

    # RLE-encode the kept reads.
    keep_ids = np.flatnonzero(keep)
    if keep_ids.shape[0] == n:
        # Nothing discarded (the common case): reuse the parsed flat
        # arrays instead of copying hundreds of MB through a repeated
        # boolean mask.
        kept_codes = np.ascontiguousarray(codes)
        kept_lengths = raw_lengths
        kept_offsets = np.asarray(offsets, np.int64)
    else:
        # Build a flat array of just the kept reads.
        keep_mask_flat = np.repeat(keep, raw_lengths)
        kept_codes = codes[keep_mask_flat]
        kept_lengths = raw_lengths[keep_ids]
        kept_offsets = np.zeros(keep_ids.shape[0] + 1, dtype=np.int64)
        np.cumsum(kept_lengths, out=kept_offsets[1:])

    if representation == 0:
        # Raw mode: store the sequence as-is with unit repeat counts;
        # no run-length filter applies (runs are not encoded).
        return ReadStore(
            rle_bases=kept_codes.astype(np.uint8),
            repeat_counts=np.ones(kept_codes.shape[0], np.uint8),
            offsets=kept_offsets,
            raw_lengths=kept_lengths.astype(np.int64),
            names=[parsed.names[i] for i in keep_ids],
            metadata=(
                [parsed.metadata[i] for i in keep_ids] if parsed.metadata else []
            ),
            discards=discards,
            representation=0,
        )

    rle_bases, counts, rle_offsets, bad_seq = R.rle_encode_store(
        kept_codes, kept_offsets
    )

    # Discard reads with any run longer than 255.
    if bad_seq.any():
        bad_run_reads = np.flatnonzero(bad_seq)
        keep2 = ~bad_seq
        discards.long_run_read_count = int(bad_run_reads.shape[0])
        discards.long_run_read_base_count = int(kept_lengths[bad_run_reads].sum())

        rle_lengths = np.diff(rle_offsets)
        keep_mask_rle = np.repeat(keep2, rle_lengths)
        rle_bases = rle_bases[keep_mask_rle]
        counts = counts[keep_mask_rle]
        new_rle_offsets = np.zeros(int(keep2.sum()) + 1, dtype=np.int64)
        np.cumsum(rle_lengths[keep2], out=new_rle_offsets[1:])
        rle_offsets = new_rle_offsets
        keep_ids = keep_ids[keep2]
        kept_lengths = kept_lengths[keep2]

    names = [parsed.names[i] for i in keep_ids]
    metadata = [parsed.metadata[i] for i in keep_ids] if parsed.metadata else []

    return ReadStore(
        rle_bases=rle_bases,
        repeat_counts=counts,
        offsets=rle_offsets,
        raw_lengths=kept_lengths.astype(np.int64),
        names=names,
        metadata=metadata,
        discards=discards,
    )


def apply_desired_coverage(store: ReadStore, desired_coverage: int) -> "ReadStore":
    """Raise the effective length cutoff until total raw bases drop to
    ``desired_coverage`` (reference:
    Assembler::adjustCoverageAndGetNewMinReadLength, used at
    srcMain/main.cpp:557-582): keep the longest reads whose cumulative
    raw length fits the budget; every kept read is at least as long as
    every dropped one."""
    if desired_coverage <= 0 or store.total_raw_bases <= desired_coverage:
        return store
    order = np.argsort(-store.raw_lengths, kind="stable")
    cum = np.cumsum(store.raw_lengths[order])
    n_keep = int(np.searchsorted(cum, desired_coverage, side="right"))
    if n_keep == 0:
        raise RuntimeError(
            "desired coverage smaller than the longest single read"
        )
    cutoff = int(store.raw_lengths[order[n_keep - 1]])
    keep = store.raw_lengths >= cutoff
    # Tie handling: trim ties beyond the budget deterministically by id.
    if int(store.raw_lengths[keep].sum()) > desired_coverage:
        tie_ids = np.flatnonzero(store.raw_lengths == cutoff)
        over = int(store.raw_lengths[keep].sum()) - desired_coverage
        n_drop = min(len(tie_ids), (over + cutoff - 1) // cutoff)
        keep[tie_ids[len(tie_ids) - n_drop :]] = False

    keep_ids = np.flatnonzero(keep)
    rle_lengths = np.diff(store.offsets)
    mask_flat = np.repeat(keep, rle_lengths)
    new_offsets = np.zeros(keep_ids.shape[0] + 1, np.int64)
    np.cumsum(rle_lengths[keep_ids], out=new_offsets[1:])
    return ReadStore(
        rle_bases=store.rle_bases[mask_flat],
        repeat_counts=store.repeat_counts[mask_flat],
        offsets=new_offsets,
        raw_lengths=store.raw_lengths[keep_ids],
        names=[store.names[i] for i in keep_ids],
        metadata=[store.metadata[i] for i in keep_ids] if store.metadata else [],
        discards=store.discards,
        representation=store.representation,
    )
