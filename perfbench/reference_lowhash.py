"""Plain reference of LowHash's output: which pairs of reads are
alignment candidates, and how often each was found (Shasta's LowHash0,
``src/LowHash0.cpp``, as ``findAlignmentCandidatesLowHash`` runs it).

It works everything out again from the reads the benchmark generated and
the configuration's parameters, with its own markers
(``reference.Markers``); it imports nothing of the program. From the
program it takes only the palindromic flags, the answer of an earlier
stage.

Per iteration ``it`` (0 to ``iterations`` - 1):

1. A feature is ``m`` consecutive markers of an oriented read (read
   ``r``, strand ``s``; oriented read id 2 r + s) that is not flagged
   palindromic. Its hash is MurmurHash64A of the ``m`` k-mer ids as
   4-byte little-endian words, seed 37 ``it``; it is low when below
   ``hash_fraction`` x 2^64.
2. A low feature's bucket is the hash's low ``log2_buckets`` bits
   (automatic: 5 plus the bit length of ``hash_fraction`` x the number of
   markers of every oriented read, at most 31). A bucket is usable when
   it holds from max(2, ``min_bucket_size``) to ``max_bucket_size`` low
   features, all reads counted.
3. Every two features of one usable bucket whose hashes also agree in
   their high 32 bits, on two different reads, are a hit of the pair
   (lower read id, higher read id, same strand or not).

A pair hit at least ``min_frequency`` times over all iterations is a
candidate. With ``reads`` given, only the hits of pairs with a read in
that set are counted (every feature still sizes the buckets), so that
a block of reads can be checked at a cell's size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional

import numpy as np

from perfbench.reference import Markers

_M = np.uint64(0xC6A4A7935BD1E995)
_R = np.uint64(47)


@dataclass
class LowHashParams:
    m: int
    hash_fraction: float
    iterations: int
    log2_buckets: int
    min_bucket_size: int
    max_bucket_size: int
    min_frequency: int

    @classmethod
    def from_config(cls, cfg: dict) -> "LowHashParams":
        r = cfg["reference"]
        return cls(**{f: r[f"lowhash_{f}"] for f in cls.__dataclass_fields__})


def murmur64a_words(words: np.ndarray, seed: int) -> np.ndarray:
    """MurmurHash64A of each row of ``words`` ((n, m) uint32), read as
    4 m little-endian bytes."""
    words = np.asarray(words, np.uint32)
    n, m = words.shape
    with np.errstate(over="ignore"):
        h = np.full(n, np.uint64(seed) ^ (np.uint64(4 * m) * _M), np.uint64)
        for c in range(m // 2):
            k = words[:, 2 * c].astype(np.uint64) | (words[:, 2 * c + 1].astype(np.uint64)
                                                      << np.uint64(32))
            k = k * _M
            k ^= k >> _R
            k = k * _M
            h ^= k
            h = h * _M
        if m % 2:
            h ^= words[:, m - 1].astype(np.uint64)
            h = h * _M
        h ^= h >> _R
        h = h * _M
        h ^= h >> _R
    return h


def _features(markers: Markers, n_reads: int, palindromic: np.ndarray, m: int):
    """(oriented read id, (n, m) words) of every feature, and the markers
    of every oriented read counted."""
    orids, words, total = [], [], 0
    for r in range(n_reads):
        for s in (0, 1):
            ids = markers.get(r, s)
            total += ids.shape[0]
            n = ids.shape[0] - m + 1
            if palindromic[r] or n <= 0:
                continue
            w = np.stack([ids[j: j + n] for j in range(m)], axis=1).astype(np.uint32)
            words.append(w)
            orids.append(np.full(n, 2 * r + s, np.int64))
    if not words:
        return np.zeros(0, np.int64), np.zeros((0, m), np.uint32), total
    return np.concatenate(orids), np.concatenate(words), total


def candidates(markers: Markers, n_reads: int, palindromic: np.ndarray,
               p: LowHashParams, reads: Optional[Iterable[int]] = None) -> Dict[str, np.ndarray]:
    """The candidates (``read_id0``, ``read_id1``, ``same_strand``,
    ``frequency``), ordered by (read_id0, read_id1, same_strand); only
    those with a read in ``reads`` when given."""
    orids, words, total = _features(markers, n_reads, np.asarray(palindromic, bool), p.m)
    log2 = p.log2_buckets
    if log2 == 0:
        log2 = min(31, 5 + max(1, int(p.hash_fraction * total)).bit_length())
    threshold = np.uint64(min(int(p.hash_fraction * float(2 ** 64)), 2 ** 64 - 1))
    touched = np.ones(n_reads, bool)
    if reads is not None:
        touched[:] = False
        touched[np.asarray(list(reads), np.int64)] = True
    lo_size = max(2, p.min_bucket_size)
    hits = []
    for it in range(p.iterations):
        h = murmur64a_words(words, 37 * it)
        low = h < threshold
        o, h = orids[low], h[low]
        bucket = h & np.uint64((1 << log2) - 1)
        _, where, size = np.unique(bucket, return_inverse=True, return_counts=True)
        usable = (size[where] >= lo_size) & (size[where] <= p.max_bucket_size)
        o, bucket, high = o[usable], bucket[usable], h[usable] >> np.uint64(32)
        # Collision groups: one bucket and one high half.
        _, group = np.unique(np.stack([bucket, high], axis=1), axis=0, return_inverse=True)
        group = group.reshape(-1)
        by = np.argsort(group, kind="stable")
        start = np.searchsorted(group[by], group, side="left")
        end = np.searchsorted(group[by], group, side="right")
        # Every entry on a touched read meets every other entry of its
        # group; a hit between two touched reads is met from both sides
        # and kept from the lower entry's side only.
        e = np.flatnonzero(touched[o >> 1])
        n_meet = end[e] - start[e]
        e_rep = np.repeat(e, n_meet)
        f = by[np.repeat(start[e], n_meet) + (np.arange(n_meet.sum())
                                               - np.repeat(np.cumsum(n_meet) - n_meet, n_meet))]
        ra, rb = o[e_rep] >> 1, o[f] >> 1
        keep = (ra != rb) & (~touched[rb] | (e_rep < f))
        ra, rb = ra[keep], rb[keep]
        same = (o[e_rep][keep] & 1) == (o[f][keep] & 1)
        hits.append((np.minimum(ra, rb) << 33) | (np.maximum(ra, rb) << 1) | same)
    keys = np.concatenate(hits) if hits else np.zeros(0, np.int64)
    uniq, freq = np.unique(keys, return_counts=True)
    ok = freq >= p.min_frequency
    uniq, freq = uniq[ok], freq[ok]
    return {
        "read_id0": (uniq >> 33).astype(np.int32),
        "read_id1": ((uniq >> 1) & 0xFFFFFFFF).astype(np.int32),
        "same_strand": (uniq & 1).astype(bool),
        "frequency": freq.astype(np.int32),
    }
