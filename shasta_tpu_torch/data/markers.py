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

The k-mer scan is the native library's (native/shasta_native.cpp
markers_count, markers_fill); ``rolling_kmers_flat`` is the numpy
Horner pack that data/kmers.py's frequency counts use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from shasta_tpu_torch.data.kmers import KmerTable
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
    """Scan all reads for marker k-mers; build the oriented-read CSR
    (one fused threaded native pass, count then fill)."""
    from shasta_tpu_torch import native

    moff, kmer_ids, positions = native.find_markers_native(
        reads.rle_bases, reads.offsets, kmer_table.k, kmer_table.is_marker
    )
    return MarkerStore(
        k=kmer_table.k, kmer_ids=kmer_ids, positions=positions, offsets=moff
    )
