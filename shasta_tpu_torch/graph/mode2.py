"""Mode 2 assembly: phased diploid via bubbles + Bayesian phasing.

Counterpart of the reference's mode-2 pipeline
(reference: srcMain/main.cpp:1049-1110, src/AssemblyGraph2.cpp:44-233,
src/PhasingGraph.{hpp,cpp}, src/diploidBayesianPhase.cpp,
src/AssemblerMarkerGraphEdges.cpp:31 for strict edges):

1. *Strict* marker graph edges: marker intervals grouped by
   (source vertex, target vertex) are split by their exact intervening
   RLE sequence — heterozygous loci become pairs of parallel edges
   (bubbles) instead of being collapsed; minEdgeCoverage and
   minEdgeCoveragePerStrand are enforced per distinct sequence.
2. The assembly graph is condensed as usual; a bubble is a vertex pair
   joined by exactly two parallel assembly edges.
3. Each pair of bubbles sharing enough reads gets a 2x2 matrix
   (side of bubble A x side of bubble B over common oriented reads);
   the 3-hypothesis Bayesian model (random / in phase / out of phase,
   diploidBayesianPhase) scores relative phase in decibels.
4. The phasing graph (vertices = bubbles, edges = confident relative
   phases) is phased along a maximum-weight spanning forest.
5. Output: phased haplotype paths per phased component plus a haploid
   squashed assembly.

The pair scoring is a dense matrix computation (read-by-bubble-side
incidence -> one matmul per side pair), MXU-shaped by construction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.data.reads import ReadStore
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph, create_assembly_graph
from shasta_tpu_torch.graph.marker_graph import MarkerGraph, _set_empty_edges


# ---------------------------------------------------------------------------
# Strict marker graph edges
# ---------------------------------------------------------------------------


def create_marker_graph_edges_strict(
    reads: ReadStore,
    markers: MarkerStore,
    mg: MarkerGraph,
    min_edge_coverage: int = 4,
    min_edge_coverage_per_strand: int = 1,
) -> None:
    """Strict edge creation (reference: createMarkerGraphEdgesStrict,
    src/AssemblerMarkerGraphEdges.cpp:31-360): consecutive in-vertex
    markers per oriented read generate marker intervals; intervals with
    the same (source, target) split into one edge per distinct
    intervening RLE sequence; coverage thresholds apply per edge."""
    moff = markers.offsets
    vt = mg.vertex_table
    valid = np.flatnonzero(vt >= 0)
    if valid.shape[0] == 0:
        _set_empty_edges(mg)
        return
    orid_of_valid = np.searchsorted(moff, valid, side="right") - 1

    same = orid_of_valid[1:] == orid_of_valid[:-1]
    i0 = valid[:-1][same]
    i1 = valid[1:][same]
    if i0.shape[0] == 0:
        # No oriented read has two consecutive in-vertex markers
        # (tiny/low-coverage runs): no intervals, no edges.
        _set_empty_edges(mg)
        return
    orid = orid_of_valid[:-1][same]
    src = vt[i0]
    tgt = vt[i1]
    odt = (
        np.uint16
        if int(np.diff(moff).max(initial=0)) < 65536
        else np.int32
    )
    ord0 = (i0 - moff[orid]).astype(odt)
    ord1 = (i1 - moff[orid]).astype(odt)

    # Dual 64-bit polynomial content hash per interval's intervening
    # RLE sequence (wrap-around mod 2^64), plus offset sentinel for
    # overlapping markers. The (h1, h2) pair is a 128-bit content
    # fingerprint: grouping keys on BOTH, so merging two distinct
    # sequences would need a simultaneous collision in two independent
    # hashes (< 2^-70 at any realistic interval count) — this replaces
    # the full content-compare audit, which cost as much as the
    # extraction itself. (Reference stores and compares the sequences
    # directly, src/AssemblerMarkerGraphEdges.cpp:31-360 — a deliberate
    # deviation documented in docs/ComponentMap.md.)
    k = markers.k
    pos0 = markers.positions[i0].astype(np.int64)
    pos1 = markers.positions[i1].astype(np.int64)
    n_int = i0.shape[0]
    seq_lo = pos0 + k
    seq_len = np.maximum(pos1 - seq_lo, 0)

    from shasta_tpu_torch import native as _native

    # One threaded native pass straight from the read store.
    h, h2 = _native.strict_interval_hashes_native(
        reads.rle_bases, reads.offsets, orid, pos0, pos1, k
    )

    # Group by (src, tgt, length, hash). Intervals enter already
    # sorted by (orid, ord0) — ``valid`` ascends in global marker id —
    # and every pass below is stable, so the within-group order needs
    # no sort key of its own. The two hash keys take np.argsort
    # passes; the dense keys (length, target, source) take native
    # linear counting passes. The resulting order is byte-identical to
    # a lexsort over (ord, h2, h, len, src*n_v+tgt) at roughly half
    # the cost (this sort was 44.7 s of the 25 Mb diploid run).
    n_v = np.int64(mg.vertex_count)

    def _stable_counting_pass(key, n_bins, perm):
        k = key[perm]
        starts = np.zeros(n_bins, np.int64)
        np.cumsum(np.bincount(k, minlength=n_bins)[:-1], out=starts[1:])
        return perm[_native.counting_sort_by_key_native(k, starts)]

    order = np.argsort(h2, kind="stable")
    order = order[np.argsort(h[order], kind="stable")]
    max_len = int(seq_len.max()) + 1 if n_int else 1
    order = _stable_counting_pass(seq_len, max_len, order)
    order = _stable_counting_pass(tgt, int(n_v), order)
    order = _stable_counting_pass(src, int(n_v), order)
    src, tgt, orid, ord0, ord1 = (
        src[order], tgt[order], orid[order], ord0[order], ord1[order]
    )
    h_s, h2_s, len_s = h[order], h2[order], seq_len[order]
    new_edge = np.empty(src.shape[0], dtype=bool)
    new_edge[0] = True
    new_edge[1:] = (
        (src[1:] != src[:-1])
        | (tgt[1:] != tgt[:-1])
        | (len_s[1:] != len_s[:-1])
        | (h_s[1:] != h_s[:-1])
        | (h2_s[1:] != h2_s[:-1])
    )
    group = np.cumsum(new_edge) - 1

    n_groups = int(group[-1]) + 1
    cov = np.bincount(group, minlength=n_groups)
    strand1 = np.bincount(group, weights=(orid & 1), minlength=n_groups)
    strand0 = cov - strand1

    keep = (
        (cov >= min_edge_coverage)
        & (strand0 >= min_edge_coverage_per_strand)
        & (strand1 >= min_edge_coverage_per_strand)
    )
    keep_interval = keep[group]

    src, tgt, orid, ord0, ord1, group = (
        src[keep_interval],
        tgt[keep_interval],
        orid[keep_interval],
        ord0[keep_interval],
        ord1[keep_interval],
        group[keep_interval],
    )
    # Renumber groups -> edge ids, ordered by (src, tgt, first
    # interval). ``group`` is nondecreasing by construction, so the
    # renumbering is a diff/cumsum — np.unique would re-sort all
    # intervals for nothing.
    if group.shape[0]:
        new2 = np.empty(group.shape[0], bool)
        new2[0] = True
        np.not_equal(group[1:], group[:-1], out=new2[1:])
        edge_of_interval = np.cumsum(new2) - 1
        n_edges = int(edge_of_interval[-1]) + 1
    else:
        edge_of_interval = np.zeros(0, np.int64)
        n_edges = 0

    e_src = np.zeros(n_edges, np.int64)
    e_tgt = np.zeros(n_edges, np.int64)
    e_src[edge_of_interval] = src
    e_tgt[edge_of_interval] = tgt
    e_cov = np.bincount(edge_of_interval, minlength=n_edges).astype(np.int32)
    interval_offsets = np.zeros(n_edges + 1, np.int64)
    np.cumsum(e_cov, out=interval_offsets[1:])
    # Intervals are already sorted by edge then (orid, ord0);
    # edge_of_interval is nondecreasing, so the "sort" is the identity.
    order2 = np.arange(edge_of_interval.shape[0], dtype=np.int64)

    # RC edges: (s, t) -> (rc t, rc s); with parallel edges, pair by
    # coverage rank among parallels between the same rc vertex pair.
    key = e_src * np.int64(mg.vertex_count) + e_tgt
    rc_key = mg.rc_vertex[e_tgt] * np.int64(mg.vertex_count) + mg.rc_vertex[e_src]
    order_k = np.argsort(key, kind="stable")
    sorted_keys = key[order_k]
    rc_edge = np.full(n_edges, -1, np.int64)
    lo_all = np.searchsorted(sorted_keys, rc_key, side="left")
    hi_all = np.searchsorted(sorted_keys, rc_key, side="right")
    single = hi_all - lo_all == 1
    rc_edge[single] = order_k[lo_all[single]]
    # Parallel edges (bubble branches between one rc vertex pair):
    # coverage can tie — e.g. a balanced diploid bubble — and
    # coverage-rank matching then breaks the rc involution. Match by
    # the exact reverse-complemented interval set instead: the rc edge
    # of e contains precisely the rc'd intervals of e.
    multi = np.flatnonzero(hi_all - lo_all > 1)
    if multi.shape[0]:
        # Order-independent per-edge interval-set fingerprints: XOR of
        # a mixed hash of each interval's (orid, ord0, ord1), and the
        # rc fingerprint over the rc'd tuples. Only edges inside a
        # parallel group can need a fingerprint, so the pass runs over
        # just those edges' intervals (bubble branches — thousands)
        # rather than all n_int (tens of millions at genome scale;
        # this was 34 s of the 25 Mb diploid run when computed fully).
        cnt = (hi_all - lo_all)[multi]
        cum = np.cumsum(cnt)
        seg_start = cum - cnt
        flat = order_k[
            np.repeat(lo_all[multi], cnt)
            + np.arange(int(cum[-1]), dtype=np.int64)
            - np.repeat(seg_start, cnt)
        ]
        needed = np.unique(np.concatenate((multi, flat)))
        pos = np.full(n_edges, -1, np.int64)
        pos[needed] = np.arange(needed.shape[0])
        icnt = e_cov[needed].astype(np.int64)
        icum = np.cumsum(icnt)
        sub = (
            np.repeat(interval_offsets[needed], icnt)
            + np.arange(int(icum[-1]), dtype=np.int64)
            - np.repeat(icum - icnt, icnt)
        )
        orid_s = orid[sub].astype(np.uint64)
        o0_s = ord0[sub].astype(np.int64)
        o1_s = ord1[sub].astype(np.int64)
        n_mark = np.diff(moff)
        n2 = n_mark[orid[sub].astype(np.int64)].astype(np.int64)

        def _mix3(a, b, c):
            with np.errstate(over="ignore"):
                x = (
                    a * np.uint64(0x9E3779B97F4A7C15)
                    + b.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
                    + c.astype(np.uint64) * np.uint64(0x165667B19E3779F9)
                )
                x ^= x >> np.uint64(33)
                x *= np.uint64(0xFF51AFD7ED558CCD)
                x ^= x >> np.uint64(29)
            return x

        fwd_h = _mix3(orid_s, o0_s, o1_s)
        rc_h = _mix3(orid_s ^ np.uint64(1), n2 - 1 - o1_s, n2 - 1 - o0_s)
        fwd_fp = np.bitwise_xor.reduceat(fwd_h, icum - icnt)
        rc_fp = np.bitwise_xor.reduceat(rc_h, icum - icnt)
        # First fingerprint match per parallel group (falling back to
        # the first candidate), without a per-edge Python loop.
        ok = fwd_fp[pos[flat]] == np.repeat(rc_fp[pos[multi]], cnt)
        wpos = (
            np.arange(flat.shape[0], dtype=np.int64)
            - np.repeat(seg_start, cnt)
        )
        big = np.int64(1) << np.int64(60)
        first = np.minimum.reduceat(np.where(ok, wpos, big), seg_start)
        rc_edge[multi] = flat[seg_start + np.where(first < big, first, 0)]

    mg.source = e_src
    mg.target = e_tgt
    mg.coverage = e_cov
    mg.rc_edge = rc_edge
    mg.removed_tr = np.zeros(n_edges, bool)
    mg.pruned = np.zeros(n_edges, bool)
    mg.superbubble = np.zeros(n_edges, bool)
    mg.low_coverage_cross = np.zeros(n_edges, bool)
    mg.interval_offsets = interval_offsets
    mg.interval_orid = orid[order2].astype(
        np.int32 if moff.shape[0] < 2**31 else np.int64, copy=False
    )
    mg.interval_ord0 = ord0[order2]
    mg.interval_ord1 = ord1[order2]
    mg.build_adjacency()


def create_marker_graph_secondary_edges(
    markers: MarkerStore,
    mg: MarkerGraph,
    max_skip: int = 1000000,
    aggressive: bool = False,
) -> int:
    """Add secondary edges to restore contiguity after strict edge
    creation (reference: createMarkerGraphSecondaryEdges,
    src/AssemblerMarkerGraphEdges.cpp:426-560): for each forward dead
    end v0 (out-degree 0), follow each of its markers to the next
    surviving vertex within max_skip ordinals; the most frequent
    target (restricted to backward dead ends unless aggressive)
    becomes a secondary edge, added together with its reverse
    complement. Returns the number of edges added."""
    n_v = mg.vertex_count
    if n_v == 0 or mg.edge_count == 0:
        return 0
    alive = mg.alive()
    out_deg = np.bincount(mg.source[alive], minlength=n_v)
    in_deg = np.bincount(mg.target[alive], minlength=n_v)
    moff = markers.offsets
    counts = np.diff(moff)
    vt = mg.vertex_table

    def next_vertices(v0):
        """(orid, ord0, ord1, v1) for each marker of v0 with a next
        surviving vertex within max_skip."""
        out = []
        for m in mg.vertex_marker_ids(int(v0)):
            orid = int(np.searchsorted(moff, m, side="right") - 1)
            ord0 = int(m - moff[orid])
            hi = min(int(counts[orid]), ord0 + 1 + max_skip)
            nxt = vt[moff[orid] + ord0 + 1 : moff[orid] + hi]
            pos = np.flatnonzero(nxt >= 0)
            if pos.shape[0]:
                out.append((orid, ord0, ord0 + 1 + int(pos[0]), int(nxt[pos[0]])))
        return out

    fwd_dead = np.flatnonzero(out_deg == 0)
    is_bwd_dead = in_deg == 0

    new_pairs = []
    for v0 in fwd_dead:
        cands = []
        for orid, o0, o1, v1 in next_vertices(v0):
            if v1 == v0:
                continue
            if not aggressive and not is_bwd_dead[v1]:
                continue
            cands.append(v1)
        if not cands:
            continue
        uniq, cnt = np.unique(cands, return_counts=True)
        v1 = int(uniq[np.argmax(cnt)])
        new_pairs.append((int(v0), v1))
        new_pairs.append((int(mg.rc_vertex[v1]), int(mg.rc_vertex[v0])))
    new_pairs = sorted(set(new_pairs))
    if not new_pairs:
        return 0

    add_src, add_tgt, add_cov, lengths = [], [], [], []
    add_orid, add_ord0, add_ord1 = [], [], []
    for v0, v1 in new_pairs:
        ivs = [
            (orid, o0, o1)
            for orid, o0, o1, v in next_vertices(v0)
            if v == v1
        ]
        add_src.append(v0)
        add_tgt.append(v1)
        add_cov.append(max(1, len(ivs)))
        lengths.append(len(ivs))
        for orid, o0, o1 in ivs:
            add_orid.append(orid)
            add_ord0.append(o0)
            add_ord1.append(o1)

    n_old = mg.edge_count
    n_new = len(add_src)
    pair_pos = {p: n_old + i for i, p in enumerate(new_pairs)}

    mg.source = np.concatenate([mg.source, np.array(add_src, np.int64)])
    mg.target = np.concatenate([mg.target, np.array(add_tgt, np.int64)])
    mg.coverage = np.concatenate([mg.coverage, np.array(add_cov, np.int32)])
    rc_new = np.empty(n_new, np.int64)
    for i, (v0, v1) in enumerate(new_pairs):
        rc_pair = (int(mg.rc_vertex[v1]), int(mg.rc_vertex[v0]))
        rc_new[i] = pair_pos.get(rc_pair, n_old + i)
    mg.rc_edge = np.concatenate([mg.rc_edge, rc_new])
    for name in ("removed_tr", "pruned", "superbubble", "low_coverage_cross"):
        setattr(
            mg, name, np.concatenate([getattr(mg, name), np.zeros(n_new, bool)])
        )
    # Track which edges are secondary (AssemblyGraph2 branches record
    # containsSecondaryEdges; reference: AssemblyGraph2Edge::Branch).
    prev = getattr(mg, "is_secondary", None)
    if prev is None:
        prev = np.zeros(n_old, bool)
    mg.is_secondary = np.concatenate([prev, np.ones(n_new, bool)])
    new_offsets = mg.interval_offsets[-1] + np.cumsum([0] + lengths)
    mg.interval_offsets = np.concatenate([mg.interval_offsets, new_offsets[1:]])
    mg.interval_orid = np.concatenate(
        [mg.interval_orid, np.array(add_orid, mg.interval_orid.dtype)]
    )
    mg.interval_ord0 = np.concatenate(
        [mg.interval_ord0, np.array(add_ord0, np.int32)]
    )
    mg.interval_ord1 = np.concatenate(
        [mg.interval_ord1, np.array(add_ord1, np.int32)]
    )
    mg.build_adjacency()
    return n_new


def cluster_edge_oriented_reads(
    reads,
    markers: MarkerStore,
    mg: MarkerGraph,
    edge_id: int,
    error_rate_threshold: float,
):
    """Cluster the marker intervals of one edge by the similarity of
    their RLE fill sequences, single linkage; clusters sorted by
    decreasing size (reference:
    Assembler::clusterMarkerGraphEdgeOrientedReads). Returns a list of
    interval-index lists."""
    from shasta_tpu_torch.consensus.msa import nw_align

    k = markers.k
    orids, o0s, o1s = mg.edge_intervals(edge_id)
    seqs = []
    for orid, o0, o1 in zip(orids.tolist(), o0s.tolist(), o1s.tolist()):
        _km, positions = markers.get(orid)
        p0 = int(positions[o0]) + k
        p1 = int(positions[o1])
        rle = reads.read_rle(orid // 2, orid % 2)
        seqs.append(rle[p0:p1] if p1 > p0 else np.zeros(0, np.uint8))

    n = len(seqs)
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def unite(i, j):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)

    # Identical fill sequences always cluster (err 0), and the
    # single-linkage outcome depends only on sequence content — so
    # align one representative per distinct sequence instead of all
    # O(n^2) member pairs (at typical coverage most reads carry the
    # same fill sequence, so this removes nearly every NW call).
    reps: Dict[bytes, int] = {}
    for i, s in enumerate(seqs):
        key = s.tobytes()
        r = reps.setdefault(key, i)
        if r != i:
            unite(r, i)
    rep_ids = sorted(reps.values())

    for a in range(len(rep_ids)):
        for b in range(a + 1, len(rep_ids)):
            i, j = rep_ids[a], rep_ids[b]
            si, sj = seqs[i], seqs[j]
            longer = max(si.shape[0], sj.shape[0])
            if longer == 0:
                err = 0.0
            elif abs(si.shape[0] - sj.shape[0]) / longer > error_rate_threshold:
                continue
            else:
                ai, aj = nw_align(si.astype(np.int64), sj.astype(np.int64))
                mism = sum(
                    1 for x, y in zip(ai, aj)
                    if x < 0 or y < 0 or si[x] != sj[y]
                )
                err = mism / longer
            if err <= error_rate_threshold:
                unite(i, j)

    groups: Dict[int, List[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return sorted(groups.values(), key=lambda g: (-len(g), g[0]))


def split_marker_graph_secondary_edges(
    reads,
    markers: MarkerStore,
    mg: MarkerGraph,
    error_rate_threshold: float = 0.1,
    min_coverage: int = 2,
) -> Tuple[int, int]:
    """Split secondary edges whose oriented reads carry inconsistent
    fill sequences into one edge per sequence cluster (reference:
    Assembler::splitMarkerGraphSecondaryEdges,
    src/AssemblerMarkerGraphEdges.cpp:777-1000). Each RC pair is
    processed once; clusters below min_coverage are dropped except the
    largest, which is always kept. Returns (split, created) counts."""
    n_edges = mg.edge_count
    is_secondary = getattr(mg, "is_secondary", None)
    if n_edges == 0 or is_secondary is None or not is_secondary.any():
        return 0, 0
    if mg.removed_split is None:
        mg.removed_split = np.zeros(n_edges, bool)
    moff_counts = np.diff(markers.offsets)

    n_split = 0
    add = []  # (src, tgt, interval rows, rc_src, rc_tgt, rc rows)
    for e in np.flatnonzero(is_secondary):
        rc = int(mg.rc_edge[e])
        if rc < e:
            continue
        clusters = cluster_edge_oriented_reads(
            reads, markers, mg, int(e), error_rate_threshold
        )
        if len(clusters) <= 1:
            continue
        n_split += 2
        mg.removed_split[e] = True
        mg.removed_split[rc] = True
        orids, o0s, o1s = mg.edge_intervals(int(e))
        for ci, cluster in enumerate(clusters):
            if ci > 0 and len(cluster) < min_coverage:
                continue
            rows = [
                (int(orids[i]), int(o0s[i]), int(o1s[i])) for i in cluster
            ]
            # The reverse complement edge's intervals, built directly:
            # (orid, ord0, ord1) -> (orid^1, n-1-ord1, n-1-ord0).
            rc_rows = [
                (
                    orid ^ 1,
                    int(moff_counts[orid]) - 1 - o1,
                    int(moff_counts[orid]) - 1 - o0,
                )
                for orid, o0, o1 in rows
            ]
            add.append((int(mg.source[e]), int(mg.target[e]), rows,
                        int(mg.source[rc]), int(mg.target[rc]), rc_rows))

    if not add:
        return n_split, 0

    n_old = mg.edge_count
    add_src, add_tgt, add_cov = [], [], []
    add_rc, lengths = [], []
    add_orid, add_ord0, add_ord1 = [], [], []
    for src, tgt, rows, rc_src, rc_tgt, rc_rows in add:
        i = n_old + len(add_src)
        add_src += [src, rc_src]
        add_tgt += [tgt, rc_tgt]
        add_cov += [len(rows), len(rc_rows)]
        add_rc += [i + 1, i]
        for rowset in (rows, rc_rows):
            lengths.append(len(rowset))
            for orid, o0, o1 in rowset:
                add_orid.append(orid)
                add_ord0.append(o0)
                add_ord1.append(o1)

    n_new = len(add_src)
    mg.source = np.concatenate([mg.source, np.array(add_src, np.int64)])
    mg.target = np.concatenate([mg.target, np.array(add_tgt, np.int64)])
    mg.coverage = np.concatenate([mg.coverage, np.array(add_cov, np.int32)])
    mg.rc_edge = np.concatenate([mg.rc_edge, np.array(add_rc, np.int64)])
    for name in (
        "removed_tr", "pruned", "superbubble", "low_coverage_cross",
        "removed_split",
    ):
        setattr(
            mg, name, np.concatenate([getattr(mg, name), np.zeros(n_new, bool)])
        )
    mg.is_secondary = np.concatenate([is_secondary, np.ones(n_new, bool)])
    new_offsets = mg.interval_offsets[-1] + np.cumsum([0] + lengths)
    mg.interval_offsets = np.concatenate([mg.interval_offsets, new_offsets[1:]])
    mg.interval_orid = np.concatenate(
        [mg.interval_orid, np.array(add_orid, mg.interval_orid.dtype)]
    )
    mg.interval_ord0 = np.concatenate(
        [mg.interval_ord0, np.array(add_ord0, np.int32)]
    )
    mg.interval_ord1 = np.concatenate(
        [mg.interval_ord1, np.array(add_ord1, np.int32)]
    )
    mg.build_adjacency()
    return n_split, n_new


# ---------------------------------------------------------------------------
# Bayesian relative phase of two bubbles
# ---------------------------------------------------------------------------


def diploid_bayesian_phase(
    matrix: np.ndarray, epsilon: float = 0.1
) -> Tuple[float, float]:
    """The reference's 3-hypothesis model
    (reference: src/diploidBayesianPhase.cpp:25-126). matrix[s0][s1]
    counts common reads on side s0 of bubble A and side s1 of bubble B.
    Returns (logPin, logPout) in decibels relative to the random
    hypothesis."""
    m = matrix.astype(np.float64)
    n0 = m.sum(axis=1)
    n1 = m.sum(axis=0)
    n = m.sum()
    if n == 0 or n0.min() < 0:
        return 0.0, 0.0
    Prandom = np.outer(n0, n1) / (n * n)
    with np.errstate(divide="ignore", invalid="ignore"):
        Pin = epsilon * Prandom
        d_in = n0[0] * n1[0] + n0[1] * n1[1]
        if d_in > 0:
            f = (1.0 - epsilon) / d_in
            Pin[0, 0] += f * n0[0] * n1[0]
            Pin[1, 1] += f * n0[1] * n1[1]
        Pout = epsilon * Prandom
        d_out = n0[0] * n1[1] + n0[1] * n1[0]
        if d_out > 0:
            f = (1.0 - epsilon) / d_out
            Pout[0, 1] += f * n0[0] * n1[1]
            Pout[1, 0] += f * n0[1] * n1[0]
        ratio_in = np.where(Prandom > 0, Pin / np.maximum(Prandom, 1e-300), 1.0)
        ratio_out = np.where(Prandom > 0, Pout / np.maximum(Prandom, 1e-300), 1.0)
        log_pin = float((m * 10.0 * np.log10(np.maximum(ratio_in, 1e-300))).sum())
        log_pout = float((m * 10.0 * np.log10(np.maximum(ratio_out, 1e-300))).sum())
    return log_pin, log_pout


# ---------------------------------------------------------------------------
# Bubbles + phasing
# ---------------------------------------------------------------------------


@dataclass
class Bubble:
    v0: int  # source marker-graph vertex
    v1: int  # target marker-graph vertex
    branch_edges: Tuple[int, int]  # assembly edge ids of the two branches
    # Oriented reads on each branch (sorted).
    reads0: np.ndarray = None
    reads1: np.ndarray = None
    # Phasing results.
    component: int = -1
    phase: int = 0  # +1 / -1 once phased


def find_bubbles(ag: AssemblyGraph, mg: MarkerGraph) -> List[Bubble]:
    """Vertex pairs joined by exactly two parallel assembly edges."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for e in range(ag.edge_count):
        groups.setdefault((int(ag.source_v[e]), int(ag.target_v[e])), []).append(e)

    from shasta_tpu_torch.graph.detangle import _edge_oriented_reads

    bubbles = []
    for (v0, v1), es in sorted(groups.items()):
        if len(es) != 2:
            continue
        b = Bubble(v0=v0, v1=v1, branch_edges=(es[0], es[1]))
        b.reads0 = _edge_oriented_reads(ag, mg, es[0])
        b.reads1 = _edge_oriented_reads(ag, mg, es[1])
        # Reads seen on both sides are uninformative; drop them.
        common = np.intersect1d(b.reads0, b.reads1)
        b.reads0 = np.setdiff1d(b.reads0, common)
        b.reads1 = np.setdiff1d(b.reads1, common)
        bubbles.append(b)
    return bubbles


def phase_bubbles(
    bubbles: List[Bubble],
    min_log_p: float = 30.0,
    epsilon: float = 0.1,
    min_common_reads: int = 3,
) -> int:
    """Relative phases via the Bayesian model over all informative
    bubble pairs; absolute phases via a maximum-weight spanning forest
    (reference: PhasingGraph + hierarchical phasing,
    src/AssemblyGraph2.cpp:44-233). Returns component count.

    The bubble-pair read counts come from one incidence-matrix product:
    side (2B, R) x (R, 2B).
    """
    nb = len(bubbles)
    if nb == 0:
        return 0
    # Build read index.
    all_reads = np.unique(
        np.concatenate([np.concatenate([b.reads0, b.reads1]) for b in bubbles])
    )
    R = all_reads.shape[0]
    inc = np.zeros((2 * nb, R), dtype=np.float32)
    for i, b in enumerate(bubbles):
        inc[2 * i, np.searchsorted(all_reads, b.reads0)] = 1
        inc[2 * i + 1, np.searchsorted(all_reads, b.reads1)] = 1
    # counts[x, y] = |reads on side x AND side y| for all side pairs.
    counts = inc @ inc.T  # (2B, 2B) — the MXU-shaped core

    # Candidate edges.
    edges = []  # (weight, i, j, relative_phase)
    for i in range(nb):
        for j in range(i + 1, nb):
            m = np.array(
                [
                    [counts[2 * i, 2 * j], counts[2 * i, 2 * j + 1]],
                    [counts[2 * i + 1, 2 * j], counts[2 * i + 1, 2 * j + 1]],
                ]
            )
            if m.sum() < min_common_reads:
                continue
            log_pin, log_pout = diploid_bayesian_phase(m, epsilon)
            if max(log_pin, log_pout) < min_log_p:
                continue
            rel = 1 if log_pin >= log_pout else -1
            edges.append((max(log_pin, log_pout), i, j, rel))

    # Maximum-weight spanning forest (Kruskal).
    edges.sort(key=lambda t: -t[0])
    parent = list(range(nb))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    tree: List[Tuple[int, int, int]] = []
    for w, i, j, rel in edges:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
            tree.append((i, j, rel))

    # Assign phases by BFS over the forest.
    adj: Dict[int, List[Tuple[int, int]]] = {}
    for i, j, rel in tree:
        adj.setdefault(i, []).append((j, rel))
        adj.setdefault(j, []).append((i, rel))
    comp = 0
    visited = [False] * nb
    for s in range(nb):
        if visited[s]:
            continue
        stack = [s]
        visited[s] = True
        bubbles[s].phase = 1
        bubbles[s].component = comp
        while stack:
            u = stack.pop()
            for v, rel in adj.get(u, ()):
                if not visited[v]:
                    visited[v] = True
                    bubbles[v].phase = bubbles[u].phase * rel
                    bubbles[v].component = comp
                    stack.append(v)
        comp += 1
    return comp


# ---------------------------------------------------------------------------
# Output: haplotype selection
# ---------------------------------------------------------------------------


def haplotype_branch_choice(bubbles: List[Bubble], ag: AssemblyGraph) -> Dict[int, int]:
    """For each bubble branch edge, which haplotype(s) it belongs to:
    returns {assembly_edge_id: hap} with hap 0/1 per the bubble's
    phase (phase +1: branch0 -> hap0; phase -1: branch0 -> hap1)."""
    out: Dict[int, int] = {}
    for b in bubbles:
        if b.phase >= 0:
            out[b.branch_edges[0]] = 0
            out[b.branch_edges[1]] = 1
        else:
            out[b.branch_edges[0]] = 1
            out[b.branch_edges[1]] = 0
    return out


def write_mode2_outputs(
    run_dir: str,
    ag: AssemblyGraph,
    bubbles: List[Bubble],
    k: int,
    vertex_repeats,
) -> Dict[str, int]:
    """Write the phased output set (a compact version of the
    reference's Detailed/Phased/Haploid file family,
    src/AssemblyGraph2.cpp writeDetailed/writePhased/writeHaploid)."""
    import os
    from shasta_tpu_torch.graph.assembly_graph import _seq_str

    hap_of = haplotype_branch_choice(bubbles, ag)
    branch_component = {}
    for b in bubbles:
        for e in b.branch_edges:
            branch_component[e] = b.component

    stats = {"phasedBubbleCount": len(bubbles), "phasedComponentCount": 0}
    if bubbles:
        stats["phasedComponentCount"] = (
            max(b.component for b in bubbles) + 1 if bubbles else 0
        )

    # Haploid selection: for each bubble keep the stronger branch.
    drop = set()
    for b in bubbles:
        e0, e1 = b.branch_edges
        drop.add(e1 if b.reads0.shape[0] >= b.reads1.shape[0] else e0)

    # The Detailed/Phased/Haploid file family, each with
    # fasta/gfa/csv (reference:
    # AssemblyGraph2::writeDetailed/writePhased/writeHaploid).
    def edge_rows(selector):
        for e in range(ag.edge_count):
            if not ag.is_assembled_edge(e) or not selector(e):
                continue
            s = ag.raw_sequence(e)
            if s.shape[0]:
                yield e, s

    def write_family(stem, selector):
        with open(os.path.join(run_dir, f"{stem}.fasta"), "w") as f:
            for e, s in edge_rows(selector):
                if e in hap_of:
                    # Reference-style phased naming: PR.<component>.<id>
                    f.write(
                        f">PR.{branch_component.get(e, 0)}.{e} haplotype "
                        f"{hap_of[e]} length {s.shape[0]}\n{_seq_str(s)}\n"
                    )
                else:
                    f.write(f">{e} length {s.shape[0]}\n{_seq_str(s)}\n")
        with open(os.path.join(run_dir, f"{stem}.gfa"), "w") as f:
            f.write("H\tVN:Z:1.0\n")
            for e, s in edge_rows(selector):
                tags = ""
                if e in hap_of:
                    tags = (
                        f"\tHP:i:{hap_of[e] + 1}"
                        f"\tPC:i:{branch_component[e]}"
                    )
                f.write(f"S\t{e}\t{_seq_str(s)}\tLN:i:{s.shape[0]}{tags}\n")
        with open(os.path.join(run_dir, f"{stem}.csv"), "w") as f:
            f.write("Segment,Length,Haplotype,PhasedComponent\n")
            for e, s in edge_rows(selector):
                hp = hap_of.get(e, "")
                pc = branch_component.get(e, "")
                f.write(f"{e},{s.shape[0]},{hp},{pc}\n")

    write_family("Assembly-Detailed", lambda e: True)
    write_family("Assembly-Phased", lambda e: e in hap_of)
    write_family("Assembly-Haploid", lambda e: e not in drop)

    # PhasingRegions.csv (reference: AssemblyGraph2.cpp): one row per
    # phased component with its branch count and total phased length.
    comp_stats: Dict[int, List[int]] = {}
    for b in bubbles:
        st = comp_stats.setdefault(b.component, [0, 0])
        st[0] += 1
        for e in b.branch_edges:
            if ag.is_assembled_edge(e):
                st[1] += int(ag.raw_sequence(e).shape[0])
    with open(os.path.join(run_dir, "PhasingRegions.csv"), "w") as f:
        f.write("PhasedComponent,BubbleCount,PhasedLength\n")
        for cid in sorted(comp_stats):
            f.write(f"{cid},{comp_stats[cid][0]},{comp_stats[cid][1]}\n")
    return stats
