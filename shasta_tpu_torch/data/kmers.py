"""K-mer table and marker k-mer selection.

Counterpart of the reference k-mer table
(reference: src/AssemblerKmers.cpp, src/Kmer.hpp). A k-mer of length
k <= 15 is a KmerId: the 2-bit base codes packed MSB-first into a
uint32 (so lexicographic order of sequences == numeric order of ids).

Instead of a 4^k array-of-structs, we keep columnar arrays and compute
cheap functions (reverse complement, hash) on the fly:

- ``is_marker``  bool [4^k]  marker table (RC-closed invariant,
  reference: src/Marker.hpp:7-19)
- reverse complement ids via vectorized bit manipulation
- downsampling hash identical to the reference:
  MurmurHash2(kmerId + rc(kmerId), seed=13477)
  (reference: src/AssemblerKmers.cpp:182-186); its table over every id
  is built on the run's card by a hand-written kernel
  (``csrc/kmer_table.cu``) where the table carries a CUDA device, with
  numpy elsewhere

Marker selection method 0 (random selection) follows the reference
semantics (reference: src/AssemblerKmers.cpp:31-100): each k-mer and
its reverse complement are selected together with probability
p = 1 - sqrt(1 - P) so that the marginal selection probability is P.
The reference draws from std::mt19937; we instead make the draw a
deterministic hash of the canonical k-mer id, which keeps the
RC-closed invariant, is seed-reproducible, and is embarrassingly
parallel (no sequential RNG stream).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from shasta_tpu_torch.ops import hashing
from shasta_tpu_torch.utils.perf import span


# Per-byte reverse complement of 4 packed bases: byte b -> the 4 bases
# complemented and in reverse order.
_RC_BYTE = np.array(
    [
        sum(((3 - ((b >> (2 * i)) & 3)) << (2 * (3 - i))) for i in range(4))
        for b in range(256)
    ],
    dtype=np.uint32,
)


def reverse_complement_kmers(kmer_ids: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement of packed k-mer ids (byte-table
    lookup: 4 bases per byte, bytes reassembled in reverse order)."""
    x = np.asarray(kmer_ids, dtype=np.uint32)
    out = (
        (_RC_BYTE[x & np.uint32(0xFF)] << np.uint32(24))
        | (_RC_BYTE[(x >> np.uint32(8)) & np.uint32(0xFF)] << np.uint32(16))
        | (_RC_BYTE[(x >> np.uint32(16)) & np.uint32(0xFF)] << np.uint32(8))
        | _RC_BYTE[(x >> np.uint32(24)) & np.uint32(0xFF)]
    )
    # The 16-base reversal above assumes k = 16; shift down to the
    # actual k (packed ids occupy the low 2k bits).
    return (out >> np.uint32(32 - 2 * k)).astype(np.uint32)


def is_rle_kmer(kmer_ids: np.ndarray, k: int) -> np.ndarray:
    """True if the k-mer has no two consecutive equal bases (i.e. can
    occur in run-length encoded sequence)."""
    x = np.asarray(kmer_ids, dtype=np.uint32)
    ok = np.ones(x.shape, dtype=bool)
    prev = x & np.uint32(3)
    y = x >> np.uint32(2)
    for _ in range(k - 1):
        cur = y & np.uint32(3)
        ok &= cur != prev
        prev = cur
        y = y >> np.uint32(2)
    return ok


def kmer_downsampling_hash(kmer_ids: np.ndarray, k: int) -> np.ndarray:
    """The per-kmer 32-bit hash the reference uses for method-3 marker
    downsampling: MurmurHash2(kmerId + rcKmerId, seed 13477), which is
    strand-symmetric (reference: src/AssemblerKmers.cpp:182-186)."""
    rc = reverse_complement_kmers(kmer_ids, k)
    n = np.asarray(kmer_ids, dtype=np.uint64) + rc.astype(np.uint64)
    return hashing.murmur32_u64(n, 13477)


# The downsampling table of the last k asked for, {k: table}: one a process.
_TABLES: dict = {}
_TABLES_LOCK = threading.Lock()
# Tables built, by where: "device" (csrc/kmer_table.cu on the run's card)
# or "host" (numpy).
TABLE_BUILDS = {"device": 0, "host": 0}
# The last build: {"k", "path" ("device" or "host"), "seconds"}.
LAST_BUILD: dict = {}


def _table_on_card(k: int, device) -> np.ndarray:
    """The table computed on the card ``device`` by ``csrc/kmer_table.cu``
    in one launch, then copied once into a fresh numpy array (a copy to
    pageable memory, which waits for it); the device buffer is freed."""
    from shasta_tpu_torch.ops import align_kernel as K

    buf = torch.empty(1 << (2 * k), dtype=torch.int32, device=device)
    K.kmer_table(buf, k)
    table = np.empty(buf.numel(), np.uint32)
    torch.from_numpy(table.view(np.int32)).copy_(buf)
    return table


def downsampling_hash_table(k: int, device=None) -> np.ndarray:
    """:func:`kmer_downsampling_hash` of every k-mer id (uint32 [4^k]),
    read-only. A function of k alone: the table of the last k asked for
    stays in memory (1 GiB at k 14), so the runs of one process at one k
    build it once. Built on ``device`` where that is a card (about 20 s
    of numpy at k 14 becomes a kernel and a copy), on the host otherwise;
    both give the same bits."""
    with _TABLES_LOCK:
        table = _TABLES.get(k)
        if table is not None:
            return table
        _TABLES.clear()
        path = "device" if device is not None and torch.device(device).type == "cuda" else "host"
        t0 = time.perf_counter()
        with span("stage:kmers.table"):
            if path == "device":
                table = _table_on_card(k, device)
            else:
                table = kmer_downsampling_hash(np.arange(1 << (2 * k), dtype=np.uint64), k)
        table.flags.writeable = False
        _TABLES[k] = table
        TABLE_BUILDS[path] += 1
        LAST_BUILD.update(k=k, path=path, seconds=time.perf_counter() - t0)
        return table


@dataclass
class KmerTable:
    k: int
    is_marker: np.ndarray  # bool [4^k]
    # The run's device, where the downsampling table is built (a card) or
    # not (None, the CPU); not saved with the stage.
    device: Optional[torch.device] = field(default=None, compare=False)

    @property
    def kmer_count(self) -> int:
        return 1 << (2 * self.k)

    @property
    def marker_count(self) -> int:
        return int(self.is_marker.sum())

    def reverse_complement(self, kmer_ids: np.ndarray) -> np.ndarray:
        return reverse_complement_kmers(kmer_ids, self.k)

    def downsampling_hash_table(self) -> np.ndarray:
        """hash for every k-mer id (uint32 [4^k], read-only), computed
        once per k in a process, on the table's device where that is a
        card (:func:`downsampling_hash_table`)."""
        return downsampling_hash_table(self.k, self.device)

    def check_rc_closed(self) -> bool:
        ids = np.arange(self.kmer_count, dtype=np.uint64)
        rc = reverse_complement_kmers(ids, self.k)
        return bool(np.all(self.is_marker[rc] == self.is_marker))

    def arrays(self):
        return {"k": np.int64(self.k), "is_marker": self.is_marker}

    @classmethod
    def from_arrays(cls, a) -> "KmerTable":
        return cls(k=int(a["k"]), is_marker=a["is_marker"])


def _enumerate_rle_kmers(k: int) -> np.ndarray:
    """All k-mer ids with no two consecutive equal bases
    (4 * 3^(k-1) of them) — the only k-mers that can occur in
    run-length encoded sequence. Enumerating these instead of the
    full 4^k space keeps method 0 cheap at k = 14 (6.4M vs 268M)."""
    ids = np.arange(4, dtype=np.uint64)
    for _ in range(k - 1):
        last = ids & np.uint64(3)
        ids = np.concatenate(
            [
                (ids << np.uint64(2)) | ((last + np.uint64(off)) & np.uint64(3))
                for off in (1, 2, 3)
            ]
        )
    return np.sort(ids)


def select_kmers_random(k: int, probability: float, seed: int = 231) -> KmerTable:
    """Marker selection method 0: random RC-closed selection among
    RLE k-mers only (reference: AssemblerKmers.cpp:107 selects only
    k-mers with isRleKmer; non-RLE k-mers can never occur in RLE
    sequence).

    Semantics follow the reference (see module docstring); the
    Bernoulli draw per (kmer, rc) pair is hash(min(id, rc_id), seed)
    rather than a sequential mt19937 stream.
    """
    if not (0.0 <= probability <= 1.0):
        raise ValueError(f"Invalid k-mer probability {probability}")
    count = 1 << (2 * k)
    ids = _enumerate_rle_kmers(k)
    rc = reverse_complement_kmers(ids, k).astype(np.uint64)
    canonical = np.minimum(ids, rc)
    # The reference gives each (kmer, rc) pair two independent draws at
    # p = 1-sqrt(1-P) so the pair is selected with probability P
    # (reference: AssemblerKmers.cpp:62-78). We make ONE draw per pair,
    # so we use P directly.
    p = probability
    h = hashing.murmur64_features(
        np.stack(
            [
                (canonical & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                (canonical >> np.uint64(32)).astype(np.uint32),
            ],
            axis=1,
        ),
        seed,
    )
    # hash < p * 2^64, computed in float (same tie behavior as the
    # reference's `x <= p` with x uniform in [0,1)).
    threshold = np.uint64(min(int(p * float(2**64)), 2**64 - 1))
    if p >= 1.0:
        sel = np.ones(ids.shape[0], dtype=bool)
    else:
        sel = h <= threshold
    is_marker = np.zeros(count, dtype=bool)
    is_marker[ids[sel]] = True
    return KmerTable(k=k, is_marker=is_marker)


def _global_kmer_frequency(reads, k: int) -> np.ndarray:
    """Occurrences of every k-mer over all reads, strand 0 + strand 1
    (reference counts oriented reads; the RC of each occurrence counts
    for the RC k-mer)."""
    from shasta_tpu_torch.data.markers import rolling_kmers_flat

    count = 1 << (2 * k)
    kv = rolling_kmers_flat(reads.rle_bases, k)
    lens = np.diff(reads.offsets)
    read_of_p = np.repeat(np.arange(reads.read_count, dtype=np.int64), lens)[
        : kv.shape[0]
    ]
    pos_in_read = np.arange(kv.shape[0], dtype=np.int64) - reads.offsets[read_of_p]
    valid = pos_in_read <= (lens[read_of_p] - k)
    kv = kv[valid]
    freq = np.bincount(kv, minlength=count).astype(np.int64)
    rc = reverse_complement_kmers(np.arange(count, dtype=np.uint64), k)
    return freq + freq[rc]


def _select_to_density(
    k: int, eligible: np.ndarray, freq: np.ndarray, density: float, seed: int
) -> KmerTable:
    """Select random (kmer, rc) pairs among the eligible until the
    cumulative frequency reaches the requested marker density
    (reference: the random-selection loops of selectKmersBasedOnFrequency
    / selectKmers2, src/AssemblerKmers.cpp:219,580)."""
    count = 1 << (2 * k)
    ids = np.arange(count, dtype=np.uint64)
    rc = reverse_complement_kmers(ids, k).astype(np.uint64)
    canonical = np.minimum(ids, rc)
    is_canonical = canonical == ids
    cand = np.flatnonzero(eligible & eligible[rc.astype(np.int64)] & is_canonical)
    total = max(1, int(freq.sum()) // 2)  # per-strand positions

    # Deterministic shuffle by hash (seeded).
    h = hashing.murmur64_features(
        np.stack(
            [
                (cand & 0xFFFFFFFF).astype(np.uint32),
                (cand >> 32).astype(np.uint32),
            ],
            axis=1,
        ),
        seed,
    )
    order = np.argsort(h, kind="stable")
    cand = cand[order]
    pair_freq = freq[cand] + np.where(
        rc[cand] != cand.astype(np.uint64), freq[rc[cand].astype(np.int64)], 0
    )
    cum = np.cumsum(pair_freq) / (2 * total)
    n_sel = int(np.searchsorted(cum, density)) + 1
    chosen = cand[:n_sel]

    is_marker = np.zeros(count, dtype=bool)
    is_marker[chosen] = True
    is_marker[rc[chosen].astype(np.int64)] = True
    return KmerTable(k=k, is_marker=is_marker)


def select_kmers_frequency(
    reads, k: int, density: float, seed: int = 231, enrichment_threshold: float = 10.0
) -> KmerTable:
    """Marker selection method 1 (reference: selectKmersBasedOnFrequency,
    src/AssemblerKmers.cpp:219): exclude k-mers whose global frequency
    exceeds enrichment_threshold times the random expectation, then
    select randomly to the requested density."""
    count = 1 << (2 * k)
    freq = _global_kmer_frequency(reads, k)
    rle = is_rle_kmer(np.arange(count, dtype=np.uint64), k)
    n_rle = max(1, int(rle.sum()))
    expected = freq[rle].sum() / n_rle
    eligible = rle & (freq <= enrichment_threshold * max(expected, 1e-12))
    return _select_to_density(k, eligible, freq, density, seed)


def select_kmers_2(
    reads, k: int, density: float, seed: int = 231, enrichment_threshold: float = 10.0
) -> KmerTable:
    """Marker selection method 2 (reference: selectKmers2,
    src/AssemblerKmers.cpp:580): additionally exclude k-mers
    over-enriched within any single read."""
    from shasta_tpu_torch.data.markers import rolling_kmers_flat

    count = 1 << (2 * k)
    freq = _global_kmer_frequency(reads, k)
    rle = is_rle_kmer(np.arange(count, dtype=np.uint64), k)
    n_rle = max(1, int(rle.sum()))
    expected_global = freq[rle].sum() / n_rle
    eligible = rle & (freq <= enrichment_threshold * max(expected_global, 1e-12))

    # Per-read over-enrichment.
    kv = rolling_kmers_flat(reads.rle_bases, k)
    lens = np.diff(reads.offsets)
    read_of_p = np.repeat(np.arange(reads.read_count, dtype=np.int64), lens)[
        : kv.shape[0]
    ]
    pos_in_read = np.arange(kv.shape[0], dtype=np.int64) - reads.offsets[read_of_p]
    valid = pos_in_read <= (lens[read_of_p] - k)
    kv2 = kv[valid].astype(np.int64)
    rr = read_of_p[valid]
    key = rr * count + kv2
    uniq, cnt = np.unique(key, return_counts=True)
    u_read = uniq // count
    u_kmer = uniq % count
    read_positions = np.maximum(lens - k + 1, 1)
    # count / positions > threshold / n_rle  <=>  over-enriched in read
    over = cnt * n_rle > enrichment_threshold * read_positions[u_read]
    bad = np.unique(u_kmer[over])
    eligible[bad] = False
    rc_bad = reverse_complement_kmers(bad.astype(np.uint64), k)
    eligible[rc_bad.astype(np.int64)] = False
    return _select_to_density(k, eligible, freq, density, seed)


def select_kmers_4(
    reads, k: int, density: float, seed: int = 231, distance_threshold: int = 1000
) -> KmerTable:
    """Marker selection method 4 (reference: selectKmers4,
    src/AssemblerKmers.cpp:900): exclude k-mers that occur twice within
    distance_threshold RLE bases in any read."""
    from shasta_tpu_torch.data.markers import rolling_kmers_flat

    count = 1 << (2 * k)
    freq = _global_kmer_frequency(reads, k)
    rle = is_rle_kmer(np.arange(count, dtype=np.uint64), k)

    kv = rolling_kmers_flat(reads.rle_bases, k)
    lens = np.diff(reads.offsets)
    read_of_p = np.repeat(np.arange(reads.read_count, dtype=np.int64), lens)[
        : kv.shape[0]
    ]
    pos_in_read = np.arange(kv.shape[0], dtype=np.int64) - reads.offsets[read_of_p]
    valid = pos_in_read <= (lens[read_of_p] - k)
    kv2 = kv[valid].astype(np.int64)
    rr = read_of_p[valid]
    pp = pos_in_read[valid]
    order = np.lexsort((pp, kv2, rr))
    rrs, kvs, pps = rr[order], kv2[order], pp[order]
    same = (rrs[1:] == rrs[:-1]) & (kvs[1:] == kvs[:-1])
    d = pps[1:] - pps[:-1]
    close = same & (d < distance_threshold)
    bad = np.unique(kvs[1:][close])
    eligible = rle.copy()
    eligible[bad] = False
    rc_bad = reverse_complement_kmers(bad.astype(np.uint64), k)
    eligible[rc_bad.astype(np.int64)] = False
    return _select_to_density(k, eligible, freq, density, seed)


def select_kmers_from_ids(k: int, marker_ids: np.ndarray) -> KmerTable:
    """Marker selection method 3 equivalent: explicit k-mer id list
    (RC closure is enforced)."""
    count = 1 << (2 * k)
    is_marker = np.zeros(count, dtype=bool)
    ids = np.asarray(marker_ids, dtype=np.int64)
    is_marker[ids] = True
    rc = reverse_complement_kmers(ids.astype(np.uint64), k)
    is_marker[rc.astype(np.int64)] = True
    return KmerTable(k=k, is_marker=is_marker)
