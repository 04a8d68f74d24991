"""Marker extraction: occurrences of marker k-mers in RLE reads.

Counterpart of the reference MarkerFinder
(reference: src/MarkerFinder.cpp, src/Marker.hpp:42-66). The reference
stores, per oriented read, a list of CompressedMarker{kmerId, position}
in a VectorOfVectors; here markers are two flat arrays + CSR offsets
indexed by oriented read id (= read_id*2 + strand, matching
OrientedReadId.getValue()):

- ``kmer_ids``  uint32 [total_markers]
- ``positions`` uint32 [total_markers]  (position in RLE coordinates)
- ``offsets``   int64  [2*n_reads + 1]

Strand-1 markers are derived from strand-0 markers by the exact
RC identity (kmer -> rc(kmer), pos -> L-k-pos, order reversed) instead
of re-scanning the reverse-complemented sequence; the marker table's
RC-closed invariant guarantees this matches a direct scan.

The k-mer scan itself is a Horner rolling pack over the flat base
array — k vectorized passes, identical shape on numpy and jnp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from shasta_tpu_torch.data.kmers import KmerTable, reverse_complement_kmers
from shasta_tpu_torch.data.reads import ReadStore


@dataclass
class MarkerStore:
    k: int
    kmer_ids: np.ndarray  # uint32 [total]
    positions: np.ndarray  # uint32 [total]
    offsets: np.ndarray  # int64 [2*n_reads+1]

    @property
    def oriented_read_count(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def total_count(self) -> int:
        return int(self.offsets[-1])

    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def get(self, oriented_read_id: int):
        lo, hi = self.offsets[oriented_read_id], self.offsets[oriented_read_id + 1]
        return self.kmer_ids[lo:hi], self.positions[lo:hi]

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "k": np.int64(self.k),
            "kmer_ids": self.kmer_ids,
            "positions": self.positions,
            "offsets": self.offsets,
        }

    @classmethod
    def from_arrays(cls, a) -> "MarkerStore":
        return cls(
            k=int(a["k"]),
            kmer_ids=a["kmer_ids"],
            positions=a["positions"],
            offsets=a["offsets"],
        )


def rolling_kmers_flat(flat: np.ndarray, k: int) -> np.ndarray:
    """Packed k-mer ids at every flat position p (covering p..p+k-1),
    ignoring read boundaries (caller masks). Returns uint32 [N-k+1]."""
    n_pos = flat.shape[0] - k + 1
    if n_pos <= 0:
        return np.zeros(0, dtype=np.uint32)
    kv = np.zeros(n_pos, dtype=np.uint32)
    for j in range(k):
        kv = (kv << np.uint32(2)) | flat[j : j + n_pos].astype(np.uint32)
    return kv


def find_markers(reads: ReadStore, kmer_table: KmerTable) -> MarkerStore:
    """Scan all reads for marker k-mers; build the oriented-read CSR."""
    k = kmer_table.k
    flat = reads.rle_bases
    offsets = reads.offsets
    n_reads = reads.read_count
    lens = np.diff(offsets)

    if flat.shape[0] >= 1 << 20:
        # Fused threaded native scan (bit-identical; tests assert
        # equality against this vectorized numpy path).
        from shasta_tpu_torch import native

        out = native.find_markers_native(
            flat, offsets, k, kmer_table.is_marker
        )
        if out is not None:
            moff, kmer_ids, positions = out
            return MarkerStore(
                k=k, kmer_ids=kmer_ids, positions=positions, offsets=moff
            )

    kv = rolling_kmers_flat(flat, k)
    n_pos = kv.shape[0]

    if n_pos == 0:
        moff = np.zeros(2 * n_reads + 1, dtype=np.int64)
        return MarkerStore(
            k=k,
            kmer_ids=np.zeros(0, np.uint32),
            positions=np.zeros(0, np.uint32),
            offsets=moff,
        )

    read_of_p = np.repeat(np.arange(n_reads, dtype=np.int64), lens)[:n_pos]
    pos_in_read = np.arange(n_pos, dtype=np.int64) - offsets[read_of_p]
    valid = pos_in_read <= (lens[read_of_p] - k)
    sel = valid & kmer_table.is_marker[kv]

    s_read = read_of_p[sel]
    s_kmer = kv[sel]
    s_pos = pos_in_read[sel].astype(np.uint32)

    # Markers per read (strand 0); strand 1 has the same count.
    per_read = np.bincount(s_read, minlength=n_reads).astype(np.int64)
    moff = np.zeros(2 * n_reads + 1, dtype=np.int64)
    counts2 = np.empty(2 * n_reads, dtype=np.int64)
    counts2[0::2] = per_read
    counts2[1::2] = per_read
    np.cumsum(counts2, out=moff[1:])

    total = int(moff[-1])
    kmer_ids = np.empty(total, dtype=np.uint32)
    positions = np.empty(total, dtype=np.uint32)

    # Rank of each marker within its read (0-based, increasing position).
    ranks = np.arange(s_read.shape[0], dtype=np.int64) - np.concatenate(
        ([0], np.cumsum(per_read)))[s_read]

    # Strand 0: direct placement.
    dst0 = moff[2 * s_read] + ranks
    kmer_ids[dst0] = s_kmer
    positions[dst0] = s_pos

    # Strand 1: rc kmers, mirrored positions, reversed order.
    dst1 = moff[2 * s_read + 1] + (per_read[s_read] - 1 - ranks)
    kmer_ids[dst1] = reverse_complement_kmers(s_kmer, k)
    positions[dst1] = (lens[s_read] - k - s_pos).astype(np.uint32)

    return MarkerStore(k=k, kmer_ids=kmer_ids, positions=positions, offsets=moff)
