"""LowHash (modified MinHash) alignment-candidate generation.

Counterpart of the reference LowHash0
(reference: src/LowHash0.cpp:161-490). Semantics reproduced exactly:

- a feature is m consecutive marker k-mer ids of an oriented read;
- per iteration ``it``, features are hashed with MurmurHash64A
  (seed = it*37); hashes below hashFraction*2^64 are "low";
- low hashes are bucketed by ``hash & mask``; buckets with size in
  [max(2, minBucketSize), maxBucketSize] generate candidate pairs among
  entries whose high 32 hash bits also agree (collision filter);
- pair (readId0 < readId1, sameStrand) frequencies accumulate over all
  iterations and hits; pairs with frequency >= minFrequency survive.

The reference implements this with per-thread bucket fills and merges;
here each iteration is a sort/group-by over dense arrays — the same
shape a sharded device path would use (bucket-id all-to-all followed
by a segmented pair expansion), here with numpy on the host.
"""

from __future__ import annotations

import os

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.ops import hashing


@dataclass
class LowHashParams:
    """Defaults follow the reference MinHash options
    (reference: src/AssemblerOptions.cpp MinHash section)."""

    m: int = 4
    hash_fraction: float = 0.01
    iteration_count: int = 10
    log2_bucket_count: int = 0  # 0 = auto
    min_bucket_size: int = 0
    max_bucket_size: int = 10
    min_frequency: int = 2


@dataclass
class CandidatePairs:
    """Alignment candidates: (read_id0 < read_id1, same_strand)."""

    read_id0: np.ndarray  # int32
    read_id1: np.ndarray  # int32
    same_strand: np.ndarray  # bool
    frequency: np.ndarray  # int32

    @property
    def count(self) -> int:
        return self.read_id0.shape[0]

    def arrays(self):
        return {
            "read_id0": self.read_id0,
            "read_id1": self.read_id1,
            "same_strand": self.same_strand,
            "frequency": self.frequency,
        }

    @classmethod
    def from_arrays(cls, a):
        return cls(
            read_id0=a["read_id0"],
            read_id1=a["read_id1"],
            same_strand=a["same_strand"],
            frequency=a["frequency"],
        )


def all_pairs_candidates(
    n_reads: int,
    is_palindromic: Optional[np.ndarray] = None,
) -> CandidatePairs:
    """Every read pair on both relative strands, skipping LowHash
    (reference: MinHash.allPairs, src/AssemblerOptions.cpp). For tiny
    runs or debugging only: O(n_reads^2) pairs."""
    i, j = np.triu_indices(n_reads, k=1)
    if is_palindromic is not None and is_palindromic.any():
        ok = ~is_palindromic[i] & ~is_palindromic[j]
        i, j = i[ok], j[ok]
    return CandidatePairs(
        read_id0=np.concatenate([i, i]).astype(np.int32),
        read_id1=np.concatenate([j, j]).astype(np.int32),
        same_strand=np.concatenate(
            [np.ones(i.shape[0], bool), np.zeros(i.shape[0], bool)]
        ),
        frequency=np.ones(2 * i.shape[0], np.int32),
    )


def cap_candidates(pairs: CandidatePairs, keep_n: int) -> CandidatePairs:
    """Keep the keep_n highest-frequency candidates (stable order:
    frequency descending, original position ascending) — the
    counterpart of the reference's candidates-per-read early stop
    (reference: MinHash.alignmentCandidatesPerRead driving the
    LowHash iteration cutoff, src/LowHash0.cpp)."""
    if pairs.count <= keep_n:
        return pairs
    order = np.argsort(-pairs.frequency.astype(np.int64), kind="stable")[:keep_n]
    order.sort()  # preserve original order among the kept
    return CandidatePairs(
        read_id0=pairs.read_id0[order],
        read_id1=pairs.read_id1[order],
        same_strand=pairs.same_strand[order],
        frequency=pairs.frequency[order],
    )


def _auto_log2_bucket_count(total_markers: int, hash_fraction: float) -> int:
    est = max(1, int(hash_fraction * total_markers))
    log2_est = est.bit_length()  # == 64 - clz(est)
    return min(31, 5 + log2_est)


def prepare_feature_index(
    markers: MarkerStore,
    m: int,
    exclude: Optional[np.ndarray] = None,
    want_ordinals: bool = True,
):
    """Loop-invariant feature index shared by all LowHash iterations:
    (sel flat positions, orid per feature, ordinal per feature, and —
    when it fits in memory — the gathered (n, m) feature matrix).
    Only the hash seed changes per iteration, so re-deriving this per
    iteration cost several full-array passes for nothing.

    Index arrays narrow to int32 below 2^31 positions, and ords is
    None unless ``want_ordinals`` (LowHash0 never reads it): at
    SCALE=50 the int64 triple was ~4.3 GB of persistent RAM inside
    the stage's 18 GB peak."""
    kmer_ids = markers.kmer_ids
    offsets = markers.offsets
    n_or = markers.oriented_read_count
    counts = np.diff(offsets)

    n_pos = kmer_ids.shape[0] - m + 1
    if n_pos <= 0:
        z = np.zeros(0, np.int64)
        return z, z, z if want_ordinals else None, np.zeros((0, m), np.uint32)
    idt = np.int32 if n_pos + m < 2**31 else np.int64

    orid_of_p = np.repeat(np.arange(n_or, dtype=idt), counts)[:n_pos]
    ord_in_read = (
        np.arange(n_pos, dtype=np.int64) - offsets[orid_of_p]
    ).astype(idt)
    valid = ord_in_read <= (counts[orid_of_p] - m)
    if exclude is not None:
        valid &= ~exclude[orid_of_p]

    sel = np.flatnonzero(valid).astype(idt)
    feat = None
    # Materialize the (n, m) feature matrix when memory allows: the
    # per-iteration chunked re-gather measured ~25x slower than hashing
    # a materialized matrix (4.2 s vs 0.17 s per iteration at 30M
    # markers on the 4-core host), and LowHash runs 8+ iterations.
    feat_bytes = sel.shape[0] * m * 4
    budget = 1 << 30  # conservative floor: 1 GiB
    try:
        avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        budget = max(budget, min(avail // 4, 6 << 30))
    except (ValueError, OSError):  # pragma: no cover
        pass
    if feat_bytes <= budget:
        feat = np.empty((sel.shape[0], m), dtype=np.uint32)
        for j in range(m):
            feat[:, j] = kmer_ids[sel + j]
    orids_sel = orid_of_p[sel]
    ords_sel = ord_in_read[sel] if want_ordinals else None
    return sel, orids_sel, ords_sel, feat


def compute_feature_hashes(
    markers: MarkerStore,
    m: int,
    seed: int,
    exclude: Optional[np.ndarray] = None,
    chunk: int = 1 << 23,
    return_ordinals: bool = False,
    prepared=None,
):
    """Hash every feature (m consecutive markers) of every oriented read.

    Returns (orid int64[n_feat], hash uint64[n_feat]) for all valid
    features (those fully inside one oriented read and whose read is
    not excluded). ``prepared`` (from :func:`prepare_feature_index`)
    skips the loop-invariant index derivation.
    """
    if prepared is None:
        prepared = prepare_feature_index(markers, m, exclude)
    sel, orids, ords, feat = prepared
    kmer_ids = markers.kmer_ids

    if feat is not None:
        hashes = hashing.murmur64_features(feat, seed)
    else:
        hashes = np.empty(sel.shape[0], dtype=np.uint64)
        fbuf = np.empty((min(chunk, sel.shape[0]), m), dtype=np.uint32)
        for lo in range(0, sel.shape[0], chunk):
            hi = min(lo + chunk, sel.shape[0])
            block = sel[lo:hi]
            fb = fbuf[: hi - lo]
            for j in range(m):
                fb[:, j] = kmer_ids[block + j]
            hashes[lo:hi] = hashing.murmur64_features(fb, seed)
    if return_ordinals:
        assert ords is not None, "prepared index lacks ordinals"
        return orids, hashes, ords
    return orids, hashes


def compute_feature_hashes_filtered(
    markers: MarkerStore,
    m: int,
    seed: int,
    threshold: np.uint64,
    prepared,
    chunk: int = 1 << 24,
):
    """Hash features and keep only those below ``threshold``, chunked
    so the full n-feature hash array never materializes (at SCALE=50
    that array was 1.4 GB per LowHash iteration for a ~2% keep rate).
    Returns (orids_low, hashes_low), identical to filtering
    :func:`compute_feature_hashes` by ``hashes < threshold``."""
    sel, orids, _ords, feat = prepared
    kmer_ids = markers.kmer_ids
    n = sel.shape[0]
    out_o: list = []
    out_h: list = []
    fbuf = None if feat is not None else np.empty(
        (min(chunk, n), m), dtype=np.uint32
    )
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        if feat is not None:
            fb = feat[lo:hi]
        else:
            fb = fbuf[: hi - lo]
            block = sel[lo:hi]
            for j in range(m):
                fb[:, j] = kmer_ids[block + j]
        h = hashing.murmur64_features(fb, seed)
        low = np.flatnonzero(h < threshold)
        if low.shape[0]:
            out_o.append(orids[lo:hi][low].astype(np.int64))
            out_h.append(h[low])
    if not out_o:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    return np.concatenate(out_o), np.concatenate(out_h)


def find_candidates_lowhash(
    markers: MarkerStore,
    params: LowHashParams,
    is_palindromic: Optional[np.ndarray] = None,
    stats_out: Optional[dict] = None,
) -> CandidatePairs:
    """Run all LowHash iterations and return frequency-filtered pairs."""
    n_or = markers.oriented_read_count
    total_markers = markers.total_count

    log2_buckets = params.log2_bucket_count
    if log2_buckets == 0:
        log2_buckets = _auto_log2_bucket_count(total_markers, params.hash_fraction)
    mask = np.uint64((1 << log2_buckets) - 1)
    hash_threshold = np.uint64(
        min(int(params.hash_fraction * float(2**64)), 2**64 - 1)
    )

    exclude = None
    if is_palindromic is not None:
        exclude = np.repeat(is_palindromic, 2)

    min_bucket = max(2, params.min_bucket_size)
    max_bucket = params.max_bucket_size

    pair_keys = []  # uint64 keys: (r0 << 33) | (r1 << 1) | sameStrand

    prepared = prepare_feature_index(
        markers, params.m, exclude, want_ordinals=False
    )
    for it in range(params.iteration_count):
        orids, hashes = compute_feature_hashes_filtered(
            markers, params.m, it * 37, hash_threshold, prepared=prepared
        )
        if orids.shape[0] == 0:
            continue

        buckets = (hashes & mask).astype(np.uint64)
        # Bucket sizes over the FULL bucket (before the high-bits
        # collision filter), as in the reference (LowHash0.cpp:434-441).
        if stats_out is not None:
            # Bucket-size histogram + per-read sparse/good/crowded
            # counts (reference: LowHashBucketHistogram.csv at
            # LowHash0.cpp:57 and readLowHashStatistics).
            _, bucket_sizes = np.unique(buckets, return_counts=True)
            bh = np.bincount(bucket_sizes)
            hist = stats_out.setdefault("bucket_histogram", np.zeros(0, np.int64))
            if hist.shape[0] < bh.shape[0]:
                hist = np.concatenate(
                    [hist, np.zeros(bh.shape[0] - hist.shape[0], np.int64)]
                )
            hist[: bh.shape[0]] += bh
            stats_out["bucket_histogram"] = hist
            order0 = np.argsort(buckets, kind="stable")
            bs = buckets[order0]
            new_flag = np.empty(bs.shape[0], bool)
            new_flag[0] = True
            np.not_equal(bs[1:], bs[:-1], out=new_flag[1:])
            gid0 = np.cumsum(new_flag) - 1
            size_of_entry = np.bincount(gid0)[gid0]
            o_sorted0 = orids[order0]
            read_stats = stats_out.setdefault(
                "read_stats", np.zeros((markers.oriented_read_count, 3), np.int64)
            )
            lo_b = max(2, params.min_bucket_size)
            sparse = size_of_entry < lo_b
            good = (size_of_entry >= lo_b) & (size_of_entry <= params.max_bucket_size)
            crowded = size_of_entry > params.max_bucket_size
            np.add.at(read_stats[:, 0], o_sorted0[sparse], 1)
            np.add.at(read_stats[:, 1], o_sorted0[good], 1)
            np.add.at(read_stats[:, 2], o_sorted0[crowded], 1)
        order = np.argsort(buckets, kind="stable")
        b_sorted = buckets[order]
        o_sorted = orids[order]
        h_sorted = hashes[order]

        # Group bounds by bucket.
        is_new = np.empty(b_sorted.shape[0], dtype=bool)
        is_new[0] = True
        np.not_equal(b_sorted[1:], b_sorted[:-1], out=is_new[1:])
        group_id = np.cumsum(is_new) - 1
        group_sizes = np.bincount(group_id)
        entry_bucket_size = group_sizes[group_id]

        usable = (entry_bucket_size >= min_bucket) & (entry_bucket_size <= max_bucket)
        if not usable.any():
            continue

        # Within usable buckets, sub-group by high 32 bits.
        ub = b_sorted[usable]
        uo = o_sorted[usable]
        uh = (h_sorted[usable] >> np.uint64(32)).astype(np.uint64)
        key = (ub << np.uint64(32)) | uh  # log2_buckets<=31 so no overlap
        order2 = np.argsort(key, kind="stable")
        key = key[order2]
        uo = uo[order2]

        is_new2 = np.empty(key.shape[0], dtype=bool)
        is_new2[0] = True
        np.not_equal(key[1:], key[:-1], out=is_new2[1:])
        gid2 = np.cumsum(is_new2) - 1
        gsize2 = np.bincount(gid2)

        pairs = _pairs_within_groups(uo, gid2, gsize2)
        if pairs is not None:
            pair_keys.append(pairs)

    if not pair_keys:
        return CandidatePairs(
            read_id0=np.zeros(0, np.int32),
            read_id1=np.zeros(0, np.int32),
            same_strand=np.zeros(0, bool),
            frequency=np.zeros(0, np.int32),
        )

    all_keys = np.concatenate(pair_keys)
    uniq, freq = np.unique(all_keys, return_counts=True)
    keep = freq >= params.min_frequency
    uniq = uniq[keep]
    freq = freq[keep]

    r0 = (uniq >> np.uint64(33)).astype(np.int32)
    r1 = ((uniq >> np.uint64(1)) & np.uint64(0xFFFFFFFF)).astype(np.int32)
    same = (uniq & np.uint64(1)).astype(bool)
    return CandidatePairs(
        read_id0=r0, read_id1=r1, same_strand=same, frequency=freq.astype(np.int32)
    )


def candidate_feedback(
    candidates: CandidatePairs,
    read_count: int,
    m: int,
    is_palindromic: Optional[np.ndarray] = None,
):
    """Post-LowHash starvation diagnosis (reference: the per-read
    LowHash statistics at src/LowHash0.cpp:57 and the feedback rules
    of scripts/GenerateFeedback.py:72-77: fewer than 20 candidates
    per read means the MinHash phase starved).

    Returns ``(messages, stats)``: ``messages`` is empty when
    candidate generation looks healthy; ``stats`` always carries
    candidatesPerRead and the isolated (zero-candidate) read
    fraction so runs can be audited afterwards."""
    has_candidate = np.zeros(read_count, bool)
    if candidates.count:
        has_candidate[candidates.read_id0] = True
        has_candidate[candidates.read_id1] = True
    eligible = np.ones(read_count, bool)
    if is_palindromic is not None and is_palindromic.shape[0] == read_count:
        eligible &= ~is_palindromic.astype(bool)
    n_eligible = max(1, int(eligible.sum()))
    isolated = int((eligible & ~has_candidate).sum())
    per_read = candidates.count / max(1, read_count)
    stats = {
        "candidatesPerRead": round(per_read, 2),
        "isolatedReadFraction": round(isolated / n_eligible, 4),
        "isolatedReadCount": isolated,
    }
    messages = []
    if per_read < 20.0:
        msg = (
            "LowHash starvation: the MinHash phase generated only "
            f"{per_read:.1f} alignment candidates per read and "
            f"{isolated} of {n_eligible} reads have no candidate at "
            "all. Try, in order: increase MinHash.minHashIterationCount "
            "by 10 (up to 100); increase MinHash.hashFraction; "
        )
        if m == 4:
            msg += "decrease MinHash.m to 3; "
        msg += (
            "and check that MinHash.maxBucketSize exceeds the "
            "effective coverage (identical features collapse into one "
            "bucket on low-error data)."
        )
        messages.append(msg)
    return messages, stats


def get_read_meta_field(metadata: str, key: str) -> str:
    """Extract a key=value field from a read's metadata string
    (reference: Reads::getMetaData)."""
    for token in metadata.split():
        if token.startswith(key + "="):
            return token[len(key) + 1 :]
    return ""


def suppress_alignment_candidates(
    read_metadata, candidates: CandidatePairs, delta: int
) -> CandidatePairs:
    """Suppress candidates between reads from the same nanopore channel
    whose 'read=' numbers differ by less than delta — likely re-reads
    of the same molecule (reference: Assembler::suppressAlignment,
    src/AssemblerAlign.cpp:1079-1161: requires matching ch, sampleid
    and runid fields, then |read0 - read1| < delta)."""
    if delta <= 0 or candidates.count == 0:
        return candidates

    def fields(i: int):
        m = read_metadata[i] if i < len(read_metadata) else ""
        return (
            get_read_meta_field(m, "ch"),
            get_read_meta_field(m, "sampleid"),
            get_read_meta_field(m, "runid"),
            get_read_meta_field(m, "read"),
        )

    keep = np.ones(candidates.count, dtype=bool)
    cache = {}
    for i in range(candidates.count):
        r0, r1 = int(candidates.read_id0[i]), int(candidates.read_id1[i])
        f0 = cache.get(r0)
        if f0 is None:
            f0 = cache[r0] = fields(r0)
        f1 = cache.get(r1)
        if f1 is None:
            f1 = cache[r1] = fields(r1)
        if any(not a or not b for a, b in zip(f0[:3], f1[:3])):
            continue
        if f0[0] != f1[0] or f0[1] != f1[1] or f0[2] != f1[2]:
            continue
        if not f0[3] or not f1[3]:
            continue
        try:
            if abs(int(f0[3]) - int(f1[3])) < delta:
                keep[i] = False
        except ValueError:
            pass

    return CandidatePairs(
        read_id0=candidates.read_id0[keep],
        read_id1=candidates.read_id1[keep],
        same_strand=candidates.same_strand[keep],
        frequency=candidates.frequency[keep],
    )


def candidate_table(candidates: CandidatePairs, n_reads: int):
    """Per-read CSR of candidate indices (reference:
    computeCandidateTable, used by the explorer and alignment driver).
    Returns (offsets int64 [n_reads+1], candidate_ids int64)."""
    inc_read = np.concatenate([candidates.read_id0, candidates.read_id1])
    inc_cid = np.concatenate(
        [np.arange(candidates.count, dtype=np.int64)] * 2
    )
    order = np.lexsort((inc_cid, inc_read))
    offsets = np.zeros(n_reads + 1, np.int64)
    np.cumsum(np.bincount(inc_read, minlength=n_reads), out=offsets[1:])
    return offsets, inc_cid[order]


def _pairs_within_groups(
    orids: np.ndarray, group_id: np.ndarray, group_sizes: np.ndarray
) -> Optional[np.ndarray]:
    """All ordered pairs (i < j within group) of entries in each group,
    as packed keys (readId0 << 33) | (readId1 << 1) | sameStrand,
    keeping only pairs with readId0 < readId1."""
    g = group_sizes
    n_pairs_per_group = (g * (g - 1)) // 2
    total = int(n_pairs_per_group.sum())
    if total == 0:
        return None

    group_starts = np.concatenate(([0], np.cumsum(g)))[:-1]
    pg_offsets = np.concatenate(([0], np.cumsum(n_pairs_per_group)))

    # For each pair slot t in group, enumerate (i, j), i<j, in the
    # standard triangular order.
    pair_gid = np.repeat(np.arange(g.shape[0]), n_pairs_per_group)
    t = np.arange(total, dtype=np.int64) - pg_offsets[pair_gid]
    # triangular decode: i = row such that row*(2g-row-1)/2 <= t
    gg = g[pair_gid].astype(np.float64)
    i = np.floor(
        ((2 * gg - 1) - np.sqrt((2 * gg - 1) ** 2 - 8 * t)) / 2
    ).astype(np.int64)
    # fix potential fp rounding
    base = i * (2 * g[pair_gid] - i - 1) // 2
    over = base > t
    i[over] -= 1
    base = i * (2 * g[pair_gid] - i - 1) // 2
    j = t - base + i + 1

    a = orids[group_starts[pair_gid] + i]
    b = orids[group_starts[pair_gid] + j]

    ra, sa = a >> 1, a & 1
    rb, sb = b >> 1, b & 1
    lo_first = ra < rb
    r0 = np.where(lo_first, ra, rb)
    r1 = np.where(lo_first, rb, ra)
    keep = ra != rb
    same = (sa == sb).astype(np.uint64)

    keys = (
        (r0.astype(np.uint64) << np.uint64(33))
        | (r1.astype(np.uint64) << np.uint64(1))
        | same
    )
    return keys[keep]


# ---------------------------------------------------------------------------
# LowHash1: the newer implementation that also records, for every
# candidate pair, the marker ordinals of each common low-hash feature
# (reference: src/LowHash1.{hpp,cpp}, findAlignmentCandidatesLowHash1
# at src/AssemblerLowHash.cpp:137).
# ---------------------------------------------------------------------------


def _pair_indices_within_groups(group_sizes: np.ndarray):
    """(i, j, group) index triples for all unordered entry pairs within
    each group (triangular enumeration, same scheme as
    _pairs_within_groups)."""
    g = group_sizes
    n_pairs_per_group = (g * (g - 1)) // 2
    total = int(n_pairs_per_group.sum())
    if total == 0:
        return None
    group_starts = np.concatenate(([0], np.cumsum(g)))[:-1]
    pg_offsets = np.concatenate(([0], np.cumsum(n_pairs_per_group)))
    pair_gid = np.repeat(np.arange(g.shape[0]), n_pairs_per_group)
    t = np.arange(total, dtype=np.int64) - pg_offsets[pair_gid]
    gg = g[pair_gid].astype(np.float64)
    i = np.floor(((2 * gg - 1) - np.sqrt((2 * gg - 1) ** 2 - 8 * t)) / 2).astype(
        np.int64
    )
    base = i * (2 * g[pair_gid] - i - 1) // 2
    over = base > t
    i[over] -= 1
    base = i * (2 * g[pair_gid] - i - 1) // 2
    j = t - base + i + 1
    return group_starts[pair_gid] + i, group_starts[pair_gid] + j


@dataclass
class CandidatePairsWithOrdinals:
    """LowHash1 output: candidates plus, per candidate, the CSR list of
    (ordinal0, ordinal1) common features, ordinals expressed on
    (read_id0, 0) / (read_id1, same_strand ? 0 : 1)
    (reference: AlignmentCandidates.hpp:33)."""

    pairs: CandidatePairs
    feature_ord0: np.ndarray  # uint32 flat
    feature_ord1: np.ndarray  # uint32 flat
    feature_offsets: np.ndarray  # int64 [count+1]

    def features(self, i: int):
        lo, hi = self.feature_offsets[i], self.feature_offsets[i + 1]
        return self.feature_ord0[lo:hi], self.feature_ord1[lo:hi]


def find_candidates_lowhash1(
    markers: MarkerStore,
    params: LowHashParams,
    is_palindromic: Optional[np.ndarray] = None,
) -> CandidatePairsWithOrdinals:
    """LowHash1 (reference: src/LowHash1.cpp:100-533). Differences from
    LowHash0 reproduced exactly:

    - the bucket filter applies to the full bucket size with no
      high-bits sub-grouping; instead, a pair survives only if the two
      features' m k-mer ids are identical (exact collision check,
      LowHash1.cpp:414-417);
    - common features are recorded with their ordinals, normalized so
      read_id0 is on strand 0 (ordinals reflected when the lower read
      was found on strand 1, LowHash1.cpp:421-436);
    - pair frequency counts *unique* (readId1, sameStrand, ordinals)
      features after deduplication across all iterations
      (LowHash1.cpp:processCommonFeatures), not raw hits.
    """
    total_markers = markers.total_count
    log2_buckets = params.log2_bucket_count
    if log2_buckets == 0:
        log2_buckets = _auto_log2_bucket_count(total_markers, params.hash_fraction)
    mask = np.uint64((1 << log2_buckets) - 1)
    hash_threshold = np.uint64(
        min(int(params.hash_fraction * float(2**64)), 2**64 - 1)
    )
    exclude = None
    if is_palindromic is not None:
        exclude = np.repeat(is_palindromic, 2)
    min_bucket = max(2, params.min_bucket_size)
    max_bucket = params.max_bucket_size

    koff = markers.offsets
    kmer_flat = markers.kmer_ids
    marker_counts = np.diff(koff)
    m = params.m

    feat_r0, feat_r1, feat_ss, feat_o0, feat_o1 = [], [], [], [], []

    prepared = prepare_feature_index(markers, m, exclude)
    for it in range(params.iteration_count):
        orids, hashes, ords = compute_feature_hashes(
            markers, m, it * 37, exclude, return_ordinals=True,
            prepared=prepared,
        )
        low = hashes < hash_threshold
        orids, hashes, ords = orids[low], hashes[low], ords[low]
        if orids.shape[0] == 0:
            continue

        buckets = (hashes & mask).astype(np.uint64)
        order = np.argsort(buckets, kind="stable")
        b_sorted = buckets[order]
        o_sorted = orids[order]
        ord_sorted = ords[order]

        is_new = np.empty(b_sorted.shape[0], dtype=bool)
        is_new[0] = True
        np.not_equal(b_sorted[1:], b_sorted[:-1], out=is_new[1:])
        gid = np.cumsum(is_new) - 1
        gsizes = np.bincount(gid)
        entry_sz = gsizes[gid]
        usable = (entry_sz >= min_bucket) & (entry_sz <= max_bucket)
        if not usable.any():
            continue
        uo = o_sorted[usable]
        uord = ord_sorted[usable]
        ukey = b_sorted[usable]
        # Re-group after filtering.
        is_new2 = np.empty(ukey.shape[0], dtype=bool)
        is_new2[0] = True
        np.not_equal(ukey[1:], ukey[:-1], out=is_new2[1:])
        gid2 = np.cumsum(is_new2) - 1
        gsz2 = np.bincount(gid2)

        idx = _pair_indices_within_groups(gsz2)
        if idx is None:
            continue
        ia, ib = idx
        oa, ob = uo[ia], uo[ib]
        ra, rb = oa >> 1, ob >> 1
        keep = ra != rb
        if not keep.any():
            continue
        oa, ob, ra, rb = oa[keep], ob[keep], ra[keep], rb[keep]
        da, db = uord[ia[keep]], uord[ib[keep]]

        # Exact feature equality check (not just hash equality).
        pos_a = koff[oa] + da
        pos_b = koff[ob] + db
        same_feature = np.ones(pos_a.shape[0], dtype=bool)
        for jj in range(m):
            same_feature &= kmer_flat[pos_a + jj] == kmer_flat[pos_b + jj]
        if not same_feature.any():
            continue
        oa, ob, ra, rb = (
            oa[same_feature], ob[same_feature], ra[same_feature], rb[same_feature]
        )
        da, db = da[same_feature], db[same_feature]

        # Put the lower read first.
        swap = ra > rb
        oa2 = np.where(swap, ob, oa)
        ob2 = np.where(swap, oa, ob)
        da2 = np.where(swap, db, da)
        db2 = np.where(swap, da, db)
        r0 = np.where(swap, rb, ra)
        r1 = np.where(swap, ra, rb)
        s0 = oa2 & 1
        s1 = ob2 & 1
        same = s0 == s1
        # If read0 was found on strand 1, reflect both ordinals
        # (reference: LowHash1.cpp:428-436).
        flip = s0 == 1
        c0 = marker_counts[oa2]
        c1 = marker_counts[ob2]
        d0 = np.where(flip, c0 - 1 - da2, da2)
        d1 = np.where(flip, c1 - 1 - db2, db2)

        feat_r0.append(r0)
        feat_r1.append(r1)
        feat_ss.append(same)
        feat_o0.append(d0)
        feat_o1.append(d1)

    empty = CandidatePairsWithOrdinals(
        pairs=CandidatePairs(
            read_id0=np.zeros(0, np.int32),
            read_id1=np.zeros(0, np.int32),
            same_strand=np.zeros(0, bool),
            frequency=np.zeros(0, np.int32),
        ),
        feature_ord0=np.zeros(0, np.uint32),
        feature_ord1=np.zeros(0, np.uint32),
        feature_offsets=np.zeros(1, np.int64),
    )
    if not feat_r0:
        return empty

    r0 = np.concatenate(feat_r0)
    r1 = np.concatenate(feat_r1)
    ss = np.concatenate(feat_ss)
    o0 = np.concatenate(feat_o0)
    o1 = np.concatenate(feat_o1)

    # Deduplicate features and group by (r0, r1, sameStrand); sort by
    # ordinals within a group (reference sort order: readId1,
    # isSameStrand, ordinals).
    rows = np.stack(
        [r0, r1, ss.astype(np.int64), o0.astype(np.int64), o1.astype(np.int64)],
        axis=1,
    )
    rows = np.unique(rows, axis=0)
    if rows.shape[0] == 0:
        return empty
    # np.unique(axis=0) sorts lexicographically by columns, which is
    # exactly (r0, r1, ss, o0, o1) order.
    key_change = np.empty(rows.shape[0], dtype=bool)
    key_change[0] = True
    key_change[1:] = np.any(rows[1:, :3] != rows[:-1, :3], axis=1)
    pair_gid = np.cumsum(key_change) - 1
    pair_sizes = np.bincount(pair_gid)
    keep_pair = pair_sizes >= params.min_frequency
    if not keep_pair.any():
        return empty

    keep_row = keep_pair[pair_gid]
    rows = rows[keep_row]
    sizes = pair_sizes[keep_pair]
    starts = np.concatenate(([0], np.cumsum(sizes)))
    heads = rows[starts[:-1]]
    return CandidatePairsWithOrdinals(
        pairs=CandidatePairs(
            read_id0=heads[:, 0].astype(np.int32),
            read_id1=heads[:, 1].astype(np.int32),
            same_strand=heads[:, 2].astype(bool),
            frequency=sizes.astype(np.int32),
        ),
        feature_ord0=rows[:, 3].astype(np.uint32),
        feature_ord1=rows[:, 4].astype(np.uint32),
        feature_offsets=starts.astype(np.int64),
    )
