"""Mode 3 assembly: segments, read journeys, and links.

Counterpart of the reference's mode-3 assembly graph
(reference: src/mode3.{hpp,cpp}; journeys at src/mode3.hpp:64-120,
link creation at src/mode3.cpp:645-697):

- *segments* are linear chains of marker graph edges (the condensed
  assembly graph's edges);
- the *journey* of an oriented read is the sequence of segments it
  visits, derived from its marker-interval appearances ordered by
  ordinal (duplicate consecutive segments condensed);
- a *link* connects segment A to segment B when at least
  ``min_link_coverage`` oriented reads transition A -> B consecutively
  in their journeys (the reference's minCoverage = 3,
  src/mode3.cpp:668).

Everything is CSR arrays: journeys are one flat (orid-sorted) segment
array + offsets, and transition counting is a sort/group pass — the
same shapes the sharded path uses. Results persist to the stage store
as the ``Mode3-*`` equivalent of the reference's persisted binaries
(src/mode3.cpp:713-741).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph, create_assembly_graph
from shasta_tpu_torch.graph.marker_graph import MarkerGraph


@dataclass
class Mode3Graph:
    """Segments (assembly graph chains), journeys, links."""

    ag: AssemblyGraph  # segments = ag edges
    # Journeys: per oriented read, CSR of visited segment ids.
    journey_offsets: np.ndarray  # int64 [n_or + 1]
    journey_segments: np.ndarray  # int64 flat
    # Links.
    link_source: np.ndarray  # int64 [n_links]
    link_target: np.ndarray  # int64 [n_links]
    link_coverage: np.ndarray  # int32 [n_links]
    # Per-journey-entry marker-graph metadata (reference:
    # AssemblyGraphJourneyEntry::markerGraphJourneyEntries,
    # src/mode3.hpp:75-96): the edge position within the segment chain
    # and the read ordinals of the FIRST and LAST marker-graph
    # interval of each journey entry.
    journey_pos_first: np.ndarray = None  # int64 flat
    journey_pos_last: np.ndarray = None  # int64 flat
    journey_ord_first: np.ndarray = None  # int64 flat (ord0 of first)
    journey_ord_last: np.ndarray = None  # int64 flat (ord1 of last)
    # Link transitions, CSR aligned with links (reference:
    # AssemblyGraph::transitions, src/mode3.cpp:555-596): per
    # transition, the oriented read, its exit from the source segment
    # (edge position + ordinal) and its entry into the target segment.
    transition_offsets: np.ndarray = None  # int64 [n_links + 1]
    t_orid: np.ndarray = None  # int64 flat
    t_pos0: np.ndarray = None  # int64 (edge position in source chain)
    t_ord0: np.ndarray = None  # int64 (ord1 of last interval in source)
    t_pos1: np.ndarray = None  # int64 (edge position in target chain)
    t_ord1: np.ndarray = None  # int64 (ord0 of first interval in target)
    # Link classification (reference: Link::segmentsAreAdjacent /
    # separation, src/mode3.cpp:600-629).
    link_adjacent: np.ndarray = None  # bool [n_links]
    link_separation: np.ndarray = None  # int32 [n_links]

    @property
    def segment_count(self) -> int:
        return self.ag.edge_count

    @property
    def link_count(self) -> int:
        return self.link_source.shape[0]

    def journey(self, orid: int) -> np.ndarray:
        lo, hi = self.journey_offsets[orid], self.journey_offsets[orid + 1]
        return self.journey_segments[lo:hi]

    def arrays(self) -> Dict[str, np.ndarray]:
        out = {f"ag_{k}": v for k, v in self.ag.arrays().items()}
        out.update(
            journey_offsets=self.journey_offsets,
            journey_segments=self.journey_segments,
            link_source=self.link_source,
            link_target=self.link_target,
            link_coverage=self.link_coverage,
        )
        for name in (
            "journey_pos_first", "journey_pos_last",
            "journey_ord_first", "journey_ord_last",
            "transition_offsets", "t_orid", "t_pos0", "t_ord0",
            "t_pos1", "t_ord1", "link_adjacent", "link_separation",
        ):
            v = getattr(self, name)
            if v is not None:
                out[name] = v
        return out

    @classmethod
    def from_arrays(cls, a) -> "Mode3Graph":
        """Reattach from a persisted stage dict (inverse of
        :meth:`arrays`; extra keys such as cluster ids are ignored)."""
        from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph

        a = dict(a)
        ag = AssemblyGraph.from_arrays(
            {k[3:]: v for k, v in a.items() if k.startswith("ag_")}
        )
        fields = {
            f.name for f in dataclasses.fields(cls) if f.name != "ag"
        }
        kwargs = {k: v for k, v in a.items() if k in fields}
        return cls(ag=ag, **kwargs)


def create_mode3_graph(
    markers: MarkerStore,
    mg: MarkerGraph,
    min_link_coverage: int = 3,
) -> Mode3Graph:
    """Build segments, journeys, and links."""
    ag = create_assembly_graph(mg)
    n_or = markers.oriented_read_count

    # Marker graph edge -> (segment, position) table (reference:
    # computeMarkerGraphEdgeTable). With detangling disabled each
    # marker edge is in at most one segment.
    n_me = mg.edge_count
    seg_of_edge = np.full(n_me, -1, np.int64)
    pos_of_edge = np.full(n_me, -1, np.int64)
    for a in range(ag.edge_count):
        chain = ag.chain(a)
        seg_of_edge[chain] = a
        pos_of_edge[chain] = np.arange(chain.shape[0])

    # All (orid, ordinal0, segment) marker journey entries.
    orid = mg.interval_orid
    ord0 = mg.interval_ord0.astype(np.int64)
    ord1 = mg.interval_ord1.astype(np.int64)
    edge_of_interval = np.repeat(
        np.arange(n_me, dtype=np.int64), np.diff(mg.interval_offsets)
    )
    seg = seg_of_edge[edge_of_interval]
    sel = seg >= 0
    orid_s, ord0_s, seg_s = orid[sel], ord0[sel], seg[sel]
    ord1_s = ord1[sel]
    pos_s = pos_of_edge[edge_of_interval][sel]

    # Sort by (orid, ordinal) -> marker graph journeys; condense runs
    # of the same segment -> assembly graph journeys, keeping the edge
    # position + ordinals of the first and last interval of each run.
    order = np.lexsort((ord0_s, orid_s))
    orid_s, seg_s = orid_s[order], seg_s[order]
    ord0_s, ord1_s, pos_s = ord0_s[order], ord1_s[order], pos_s[order]
    if orid_s.shape[0]:
        n_i = orid_s.shape[0]
        new_entry = np.empty(n_i, dtype=bool)
        new_entry[0] = True
        new_entry[1:] = (orid_s[1:] != orid_s[:-1]) | (seg_s[1:] != seg_s[:-1])
        firsts = np.flatnonzero(new_entry)
        lasts = np.concatenate([firsts[1:] - 1, [n_i - 1]])
        j_orid = orid_s[firsts]
        j_seg = seg_s[firsts]
        j_pos_first = pos_s[firsts]
        j_pos_last = pos_s[lasts]
        j_ord_first = ord0_s[firsts]
        j_ord_last = ord1_s[lasts]
    else:
        j_orid = np.zeros(0, np.int64)
        j_seg = np.zeros(0, np.int64)
        j_pos_first = np.zeros(0, np.int64)
        j_pos_last = np.zeros(0, np.int64)
        j_ord_first = np.zeros(0, np.int64)
        j_ord_last = np.zeros(0, np.int64)

    journey_offsets = np.zeros(n_or + 1, np.int64)
    np.cumsum(np.bincount(j_orid, minlength=n_or), out=journey_offsets[1:])

    # Transitions: consecutive journey entries of the same oriented
    # read, grouped per (source, target) pair into links when coverage
    # suffices (reference: findTransitions + createLinks,
    # src/mode3.cpp:555-629).
    n_seg = ag.edge_count
    if j_orid.shape[0] > 1:
        same = j_orid[1:] == j_orid[:-1]
        t_src = j_seg[:-1][same]
        t_tgt = j_seg[1:][same]
        key = t_src * np.int64(n_seg) + t_tgt
        tr_orid = j_orid[1:][same]
        tr_pos0 = j_pos_last[:-1][same]
        tr_ord0 = j_ord_last[:-1][same]
        tr_pos1 = j_pos_first[1:][same]
        tr_ord1 = j_ord_first[1:][same]
        uniq, counts = np.unique(key, return_counts=True)
        keep = counts >= min_link_coverage
        uniq, counts = uniq[keep], counts[keep]
        link_source = uniq // n_seg
        link_target = uniq % n_seg
        link_coverage = counts.astype(np.int32)
        # CSR of transitions for kept links, sorted by (link, orid).
        link_of_key = np.searchsorted(uniq, key)
        valid = (link_of_key < uniq.shape[0]) & (
            uniq[np.minimum(link_of_key, uniq.shape[0] - 1)] == key
        )
        li = link_of_key[valid]
        t_order = np.lexsort((tr_orid[valid], li))
        li = li[t_order]
        t_orid = tr_orid[valid][t_order]
        t_pos0 = tr_pos0[valid][t_order]
        t_ord0 = tr_ord0[valid][t_order]
        t_pos1 = tr_pos1[valid][t_order]
        t_ord1 = tr_ord1[valid][t_order]
        transition_offsets = np.zeros(uniq.shape[0] + 1, np.int64)
        np.cumsum(
            np.bincount(li, minlength=uniq.shape[0]),
            out=transition_offsets[1:],
        )
    else:
        link_source = np.zeros(0, np.int64)
        link_target = np.zeros(0, np.int64)
        link_coverage = np.zeros(0, np.int32)
        transition_offsets = np.zeros(1, np.int64)
        t_orid = t_pos0 = t_ord0 = t_pos1 = t_ord1 = np.zeros(0, np.int64)

    # Link adjacency and separation (reference: createLinks,
    # src/mode3.cpp:600-629 + linkSeparation, src/mode3.hpp:626-648).
    n_links = link_source.shape[0]
    link_adjacent = np.zeros(n_links, dtype=bool)
    link_separation = np.zeros(n_links, np.int32)
    if n_links:
        src_last_edge = np.array(
            [ag.chain(int(s))[-1] for s in link_source], np.int64
        )
        tgt_first_edge = np.array(
            [ag.chain(int(t))[0] for t in link_target], np.int64
        )
        link_adjacent = mg.target[src_last_edge] == mg.source[tgt_first_edge]
        path_len0 = np.diff(ag.chain_offsets)[link_source]
        for l in range(n_links):
            if link_adjacent[l]:
                continue
            lo, hi = transition_offsets[l], transition_offsets[l + 1]
            sep = (
                (t_ord1[lo:hi] - t_ord0[lo:hi])
                - (path_len0[l] - 1 - t_pos0[lo:hi])
                - t_pos1[lo:hi]
            )
            link_separation[l] = int(np.round(sep.mean())) if hi > lo else 0

    return Mode3Graph(
        ag=ag,
        journey_offsets=journey_offsets,
        journey_segments=j_seg,
        link_source=link_source,
        link_target=link_target,
        link_coverage=link_coverage,
        journey_pos_first=j_pos_first,
        journey_pos_last=j_pos_last,
        journey_ord_first=j_ord_first,
        journey_ord_last=j_ord_last,
        transition_offsets=transition_offsets,
        t_orid=t_orid,
        t_pos0=t_pos0,
        t_ord0=t_ord0,
        t_pos1=t_pos1,
        t_ord1=t_ord1,
        link_adjacent=link_adjacent,
        link_separation=link_separation,
    )


def find_assembly_paths(m3: Mode3Graph) -> List[np.ndarray]:
    """Maximal unambiguous link chains: follow links that are the
    unique out-link of their source and unique in-link of their target
    (the skeleton of the reference's mode3 PathGraph path creation)."""
    n_seg = m3.segment_count
    out_count = np.bincount(m3.link_source, minlength=n_seg)
    in_count = np.bincount(m3.link_target, minlength=n_seg)
    next_seg = np.full(n_seg, -1, np.int64)
    uniq = (out_count[m3.link_source] == 1) & (in_count[m3.link_target] == 1)
    next_seg[m3.link_source[uniq]] = m3.link_target[uniq]
    has_pred = np.zeros(n_seg, dtype=bool)
    valid_next = next_seg[next_seg >= 0]
    has_pred[valid_next] = True

    paths = []
    visited = np.zeros(n_seg, dtype=bool)
    for s in range(n_seg):
        if visited[s] or has_pred[s]:
            continue
        path = [s]
        visited[s] = True
        cur = s
        while next_seg[cur] >= 0 and not visited[next_seg[cur]]:
            cur = int(next_seg[cur])
            path.append(cur)
            visited[cur] = True
        paths.append(np.array(path, dtype=np.int64))
    # Circular leftovers.
    for s in range(n_seg):
        if not visited[s]:
            path = [s]
            visited[s] = True
            cur = s
            while next_seg[cur] >= 0 and not visited[next_seg[cur]]:
                cur = int(next_seg[cur])
                path.append(cur)
                visited[cur] = True
            paths.append(np.array(path, dtype=np.int64))
    return paths


def flag_back_segments(m3: Mode3Graph) -> np.ndarray:
    """Back-segments: exactly one incoming and one outgoing link, both
    connecting to the same segment (reference: flagBackSegments,
    src/mode3.cpp:788-827, persisted as Mode3-IsBackSegment). Returns
    is_back_segment: bool [n_segments]."""
    n = m3.segment_count
    in_deg = np.bincount(m3.link_target, minlength=n)
    out_deg = np.bincount(m3.link_source, minlength=n)
    # For degree-1 segments, the unique incoming/outgoing link id.
    only_in = np.full(n, -1, np.int64)
    only_out = np.full(n, -1, np.int64)
    only_in[m3.link_target] = np.arange(m3.link_count)
    only_out[m3.link_source] = np.arange(m3.link_count)
    cand = (in_deg == 1) & (out_deg == 1)
    is_back = np.zeros(n, dtype=bool)
    c = np.flatnonzero(cand)
    if c.shape[0]:
        is_back[c] = (
            m3.link_source[only_in[c]] == m3.link_target[only_out[c]]
        )
    return is_back


def write_mode3_gfa(path: str, m3: Mode3Graph) -> None:
    """Segments + links as GFA (the reference explorer's mode-3 view)."""
    from shasta_tpu_torch.graph.assembly_graph import _seq_str

    with open(path, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        for s in range(m3.segment_count):
            n = int(m3.ag.chain_offsets[s + 1] - m3.ag.chain_offsets[s])
            if m3.ag.seg_raw_offsets is not None and m3.ag.is_assembled_edge(s):
                seq = m3.ag.raw_sequence(s)
                f.write(f"S\t{s}\t{_seq_str(seq)}\tLN:i:{seq.shape[0]}\n")
            else:
                f.write(f"S\t{s}\t*\tLN:i:{n}\n")
        for i in range(m3.link_count):
            f.write(
                f"L\t{m3.link_source[i]}\t+\t{m3.link_target[i]}\t+\t0M\t"
                f"RC:i:{m3.link_coverage[i]}\n"
            )


# ---------------------------------------------------------------------------
# Segment pair analysis and clustering
# ---------------------------------------------------------------------------


@dataclass
class SegmentPairInformation:
    """Analysis of two segments' shared oriented reads
    (reference: src/mode3-SegmentPairInformation.hpp)."""

    total_count: Tuple[int, int] = (0, 0)
    common_count: int = 0
    offset: int = 0  # markers, segment0 start -> segment1 start
    # Reads on one segment only that, given the offset, should have
    # reached the other segment (inconsistent) ...
    unexplained_count: Tuple[int, int] = (0, 0)
    # ... versus reads that simply end before reaching it.
    short_count: Tuple[int, int] = (0, 0)

    def jaccard(self) -> float:
        d = self.common_count + self.unexplained_count[0] + self.unexplained_count[1]
        return self.common_count / d if d else 0.0

    def maximum_unexplained_fraction(self) -> float:
        fr = []
        for i in range(2):
            d = self.common_count + self.unexplained_count[i]
            fr.append(self.unexplained_count[i] / d if d else 0.0)
        return max(fr)


def segment_oriented_read_infos(m3: Mode3Graph, mg: MarkerGraph):
    """Per segment: sorted oriented reads with their average marker
    offset relative to the segment start (reference:
    getOrientedReadsOnSegment, src/mode3.cpp:951-997).

    Returns (offsets int64[n_seg+1], orids int64, avg_offset int64,
    seg_lengths int64[n_seg]).
    """
    ag = m3.ag
    n_me = mg.edge_count
    seg_of_edge = np.full(n_me, -1, np.int64)
    pos_of_edge = np.full(n_me, -1, np.int64)
    # One flat scatter over all chains (the per-segment loop dominated
    # at tens of thousands of segments in the fragmented strict graph).
    chain_lens = np.diff(ag.chain_offsets)
    seg_of_edge[ag.chains] = np.repeat(
        np.arange(ag.edge_count, dtype=np.int64), chain_lens
    )
    pos_of_edge[ag.chains] = np.arange(
        ag.chains.shape[0], dtype=np.int64
    ) - np.repeat(ag.chain_offsets[:-1], chain_lens)

    edge_of_interval = np.repeat(
        np.arange(n_me, dtype=np.int64), np.diff(mg.interval_offsets)
    )
    seg = seg_of_edge[edge_of_interval]
    sel = seg >= 0
    seg = seg[sel]
    pos = pos_of_edge[edge_of_interval][sel]
    orid = mg.interval_orid[sel]
    o0 = mg.interval_ord0[sel].astype(np.int64)
    o1 = mg.interval_ord1[sel].astype(np.int64)

    # Per (segment, orid): n += 2; sum += (pos - ord0) + (pos+1 - ord1).
    n_seg = ag.edge_count
    key = seg * np.int64(m3.journey_offsets.shape[0]) + orid
    contrib = (pos - o0) + (pos + 1 - o1)
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.bincount(inv, weights=contrib).astype(np.int64)
    counts = np.bincount(inv) * 2
    g_seg = (uniq // m3.journey_offsets.shape[0]).astype(np.int64)
    g_orid = (uniq % m3.journey_offsets.shape[0]).astype(np.int64)
    avg = np.round(sums / counts).astype(np.int64)

    # uniq is sorted by key = (seg, orid): already CSR-grouped by
    # segment with orids ascending.
    offsets = np.searchsorted(g_seg, np.arange(n_seg + 1))
    seg_lengths = np.diff(ag.chain_offsets).astype(np.int64)
    return offsets, g_orid, avg, seg_lengths


def analyze_segment_pair(
    seg0: int,
    seg1: int,
    info_offsets: np.ndarray,
    info_orids: np.ndarray,
    info_avg: np.ndarray,
    seg_lengths: np.ndarray,
    read_marker_counts: np.ndarray,
) -> SegmentPairInformation:
    """Common reads, offset estimate, and unexplained/short counts for
    a segment pair (reference: analyzeSegmentPair,
    src/mode3.cpp:1054-1166)."""
    lo0, hi0 = info_offsets[seg0], info_offsets[seg0 + 1]
    lo1, hi1 = info_offsets[seg1], info_offsets[seg1 + 1]
    orids0, avg0 = info_orids[lo0:hi0], info_avg[lo0:hi0]
    orids1, avg1 = info_orids[lo1:hi1], info_avg[lo1:hi1]
    out = SegmentPairInformation(total_count=(int(hi0 - lo0), int(hi1 - lo1)))

    common, i0, i1 = np.intersect1d(orids0, orids1, return_indices=True)
    out.common_count = int(common.shape[0])
    if out.common_count == 0:
        return out
    out.offset = int(np.round(np.mean(avg0[i0] - avg1[i1])))

    len0 = int(seg_lengths[seg0])
    len1 = int(seg_lengths[seg1])

    only0 = np.setdiff1d(np.arange(orids0.shape[0]), i0)
    only1 = np.setdiff1d(np.arange(orids1.shape[0]), i1)

    # Reads only on segment 0: would their span overlap segment 1?
    un0 = sh0 = 0
    for t in only0:
        rl = int(read_marker_counts[orids0[t]])
        start1 = int(avg0[t]) - out.offset
        if start1 < len1 and start1 + rl > 0:
            un0 += 1
        else:
            sh0 += 1
    un1 = sh1 = 0
    for t in only1:
        rl = int(read_marker_counts[orids1[t]])
        start0 = int(avg1[t]) + out.offset
        if start0 < len0 and start0 + rl > 0:
            un1 += 1
        else:
            sh1 += 1
    out.unexplained_count = (un0, un1)
    out.short_count = (sh0, sh1)
    return out


def cluster_segments(
    m3: Mode3Graph,
    mg: MarkerGraph,
    markers: MarkerStore,
    min_cluster_size: int = 3,
    min_common_read_count: int = 10,
    max_unexplained_fraction: float = 0.25,
    min_jaccard: float = 0.7,
    pair_count_per_segment: int = 1,
    max_distance: int = 200,
) -> np.ndarray:
    """Cluster segments that carry the same reads (reference:
    clusterSegments + addClusterPairs, src/mode3.cpp:1201-1404): BFS
    from each segment over links, keeping the first pair whose common
    reads pass the Jaccard/unexplained thresholds; connected
    components of the kept pairs of size >= min_cluster_size become
    clusters, numbered by decreasing size.

    Returns cluster_id int64[n_segments] (-1 = unclustered).
    """
    n_seg = m3.segment_count
    info_offsets, info_orids, info_avg, seg_lengths = segment_oriented_read_infos(
        m3, mg
    )
    read_marker_counts = np.diff(markers.offsets)

    # Links by source.
    order = np.argsort(m3.link_source, kind="stable")
    ls, lt = m3.link_source[order], m3.link_target[order]
    src_off = np.searchsorted(ls, np.arange(n_seg + 1))

    pairs = []
    from collections import deque

    for start in range(n_seg):
        q = deque([start])
        dist = {start: 0}
        found = 0
        while q and found < pair_count_per_segment:
            s0 = q.popleft()
            d1 = dist[s0] + 1
            for li in range(src_off[s0], src_off[s0 + 1]):
                s1 = int(lt[li])
                if s1 in dist:
                    continue
                if d1 < max_distance:
                    q.append(s1)
                dist[s1] = d1
                info = analyze_segment_pair(
                    start, s1, info_offsets, info_orids, info_avg,
                    seg_lengths, read_marker_counts,
                )
                if info.common_count < min_common_read_count:
                    continue
                if info.maximum_unexplained_fraction() > max_unexplained_fraction:
                    continue
                if info.jaccard() < min_jaccard:
                    continue
                pairs.append((start, s1))
                found += 1
                if found >= pair_count_per_segment:
                    break

    # Connected components over the kept pairs.
    parent = list(range(n_seg))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    comps: Dict[int, List[int]] = {}
    for s in range(n_seg):
        comps.setdefault(find(s), []).append(s)
    clusters = [c for c in comps.values() if len(c) >= min_cluster_size]
    clusters.sort(key=len, reverse=True)

    cluster_id = np.full(n_seg, -1, np.int64)
    for cid, members in enumerate(clusters):
        cluster_id[np.asarray(members)] = cid
    return cluster_id
