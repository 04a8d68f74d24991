"""Mode 3 path construction: JaccardGraph + AssemblyPath.

Counterpart of the reference's mode-3 path machinery
(reference: src/mode3-JaccardGraph.cpp, src/mode3-AssemblyPath.cpp,
src/mode3.cpp:1924-2140):

- ``create_assembly_path`` walks links from a start segment, choosing
  at each step the link with the most reads in common with the current
  *reference segment*, and promotes a segment to the new reference
  (a *primary* segment) when its Jaccard similarity with the previous
  reference is high (reference: createAssemblyPath,
  src/mode3.cpp:1924).
- ``create_jaccard_graph`` runs one step of that search forward and
  backward from every segment; an edge found in both directions is
  *strong* (reference: createJaccardGraphEdges,
  src/mode3-JaccardGraph.cpp:100; JaccardGraphEdge::isStrong).
- ``find_jaccard_paths`` chains strong edges into maximal linear
  paths of primary segments with the intermediate (secondary)
  segments preserved (the role of the reference's
  ExpandedJaccardGraph chains, src/mode3-JaccardGraph.cpp:471).
- ``assemble_path`` assembles each path: segment sequences via the
  shared chain assembler, link sequences via an anchored MSA of the
  transition reads restricted to the adjacent primary segments, with
  identical-flank trimming (reference: AssemblyPath::assemble,
  src/mode3-AssemblyPath.cpp:28-450, computeLinkConsensusUsingSpoa
  :553).

The condensed graph is small, so the per-path walks run on host; the
MSA consensus per column is the same caller machinery the rest of the
assembler uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.data.reads import ReadStore
from shasta_tpu_torch.graph.marker_graph import MarkerGraph
from shasta_tpu_torch.graph.mode3 import Mode3Graph, segment_oriented_read_infos

INVALID = -1

# Path-search criteria (reference: createAssemblyPath,
# src/mode3.cpp:1931-1935 — "EXPOSE WHEN CODE STABILIZES").
MIN_COMMON_FOR_LINK = 3
MIN_COMMON_FOR_PRIMARY = 3
MIN_JACCARD = 0.75
MIN_LINK_SEPARATION = -20
# Corrected-Jaccard acceptance (SegmentPairInformation::jaccard —
# discounts reads whose absence the estimated offset explains,
# reference: src/mode3-SegmentPairInformation.hpp:67-71). The
# reference computes both forms and its experimental walk settled on
# rawJaccard (src/mode3.cpp: "USING RAWJACCARD INSTEAD OF JACCARD"),
# but the raw form can NEVER accept a primary across a segment-length
# mismatch — a short reference next to a long segment caps rawJaccard
# at roughly the read-set size ratio — and that measured as the
# dominant cause of Jaccard-chain breaks (docs/Design.md "Mode 3
# behavior envelope"). Accepting EITHER criterion reconnects those
# chains while error branches (genuinely discordant read sets, which
# the offset does NOT explain) stay excluded. Set to None for the
# reference's raw-only behavior. Measured on the fragmented-regime
# dataset: path N50 span 521 -> 3174 markers (6.1x), paths 170 -> 125.
MIN_JACCARD_CORRECTED = 0.75


class Mode3Connectivity:
    """Link adjacency + per-segment oriented-read info shared by the
    path searches (reference: linksBySource/linksByTarget +
    assemblyGraphJourneyInfos, src/mode3.cpp:745-786)."""

    def __init__(self, m3: Mode3Graph, mg: MarkerGraph, markers: MarkerStore):
        self.m3 = m3
        n_seg = m3.segment_count
        n_links = m3.link_count

        order = np.argsort(m3.link_source, kind="stable")
        self._links_sorted_by_source = order
        self._src_off = np.searchsorted(
            m3.link_source[order], np.arange(n_seg + 1)
        )
        order_t = np.argsort(m3.link_target, kind="stable")
        self._links_sorted_by_target = order_t
        self._tgt_off = np.searchsorted(
            m3.link_target[order_t], np.arange(n_seg + 1)
        )

        (self.info_offsets, self.info_orids, self.info_avg,
         self.seg_lengths) = segment_oriented_read_infos(m3, mg)
        self.read_marker_counts = np.diff(markers.offsets)

        # Per-link unique transition orids (reads transitioning more
        # than once are dropped, reference: analyzeSegmentLinkPair
        # duplicate skipping, src/mode3.cpp:2084-2139). One global
        # sort of (link, orid) keys instead of an np.unique per link —
        # at tens of thousands of links the per-link loop dominated
        # Jaccard-graph construction.
        if n_links:
            link_of_t = np.repeat(
                np.arange(n_links, dtype=np.int64),
                np.diff(m3.transition_offsets),
            )
            n_or_key = np.int64(max(m3.journey_offsets.shape[0] - 1, 1))
            key = link_of_t * (2 * n_or_key) + m3.t_orid.astype(np.int64)
            skey = np.sort(key)
            first = np.empty(skey.shape[0], bool)
            last = np.empty(skey.shape[0], bool)
            if skey.shape[0]:
                first[0] = True
                np.not_equal(skey[1:], skey[:-1], out=first[1:])
                last[-1] = True
                np.not_equal(skey[1:], skey[:-1], out=last[:-1])
            uniq_mask = first & last  # appears exactly once
            ukey = skey[uniq_mask]
            ulink = ukey // (2 * n_or_key)
            uorid = ukey % (2 * n_or_key)
            cuts = np.searchsorted(ulink, np.arange(n_links + 1))
            self.link_unique_orids = [
                uorid[cuts[l] : cuts[l + 1]] for l in range(n_links)
            ]
        else:
            self.link_unique_orids = []

    def links_by_source(self, seg: int) -> np.ndarray:
        return self._links_sorted_by_source[
            self._src_off[seg] : self._src_off[seg + 1]
        ]

    def links_by_target(self, seg: int) -> np.ndarray:
        return self._links_sorted_by_target[
            self._tgt_off[seg] : self._tgt_off[seg + 1]
        ]

    def segment_orids(self, seg: int) -> np.ndarray:
        return self.info_orids[self.info_offsets[seg] : self.info_offsets[seg + 1]]

    def segment_contains_orid(self, seg: int, orid: int) -> bool:
        if seg == INVALID:
            return False
        orids = self.segment_orids(seg)
        i = np.searchsorted(orids, orid)
        return i < orids.shape[0] and orids[i] == orid

    def analyze_segment_link_pair(self, seg: int, link: int) -> int:
        """Common oriented reads between a segment and a link
        (reference: analyzeSegmentLinkPair, src/mode3.cpp:2075).
        Both sides are sorted, so the intersection is a searchsorted
        membership count (np.intersect1d re-sorts on every call, and
        the path walks call this per outgoing link per step)."""
        a = self.segment_orids(seg)
        b = self.link_unique_orids[link]
        if a.shape[0] == 0 or b.shape[0] == 0:
            return 0
        i = np.searchsorted(a, b)
        ok = i < a.shape[0]
        return int((a[i[ok]] == b[ok]).sum())

    def analyze_segment_pair(self, seg0: int, seg1: int):
        from shasta_tpu_torch.graph.mode3 import analyze_segment_pair

        return analyze_segment_pair(
            seg0, seg1, self.info_offsets, self.info_orids, self.info_avg,
            self.seg_lengths, self.read_marker_counts,
        )

    def raw_jaccard(self, info) -> float:
        """(reference: SegmentPairInformation::rawJaccard,
        src/mode3-SegmentPairInformation.hpp:74)"""
        d = info.total_count[0] + info.total_count[1] - info.common_count
        return info.common_count / d if d else 0.0

    def find_link(self, seg0: int, seg1: int) -> int:
        for li in self.links_by_source(seg0):
            if self.m3.link_target[li] == seg1:
                return int(li)
        return INVALID


@dataclass
class PathSegment:
    """(reference: AssemblyPathSegment, src/mode3-AssemblyPath.hpp)"""

    id: int
    is_primary: bool
    previous_primary: int = INVALID
    next_primary: int = INVALID
    # Assembly products.
    rle: Optional[np.ndarray] = None
    rep: Optional[np.ndarray] = None
    vertex_offsets: Optional[np.ndarray] = None
    left_trim: int = 0
    right_trim: int = 0


@dataclass
class PathLink:
    """(reference: AssemblyPathLink, src/mode3-AssemblyPath.hpp)"""

    id: int
    is_trivial: bool
    previous_primary: int = INVALID
    next_primary: int = INVALID
    coverage: int = 0
    msa_rle: Optional[np.ndarray] = None
    msa_rep: Optional[np.ndarray] = None
    left_trim: int = 0
    right_trim: int = 0


@dataclass
class AssemblyPath:
    segments: List[PathSegment] = field(default_factory=list)
    links: List[PathLink] = field(default_factory=list)
    rle: Optional[np.ndarray] = None
    rep: Optional[np.ndarray] = None
    raw: Optional[np.ndarray] = None


def _walk(
    conn: Mode3Connectivity,
    start: int,
    direction: int,
    stop_at_first_primary: bool,
    candidate_mask: Optional[np.ndarray] = None,
):
    """The shared link-walk of createAssemblyPath /
    createJaccardGraphEdges. Returns (primary path segments, or the
    single Jaccard edge found). ``candidate_mask`` (Jaccard-edge
    search only) restricts which segments may END the search: masked-
    out segments are demoted to pass-through intermediates, so edges
    re-form across them (the iterative cleanup of
    create_jaccard_graph_iterative)."""
    m3 = conn.m3
    reference = start
    segments = [PathSegment(start, True)]
    last_iteration: List[int] = []
    previous_pairs = set()
    previous_segments = set()
    jaccard_edge = None
    seg0 = start
    while True:
        link_ids = (
            conn.links_by_source(seg0)
            if direction == 0
            else conn.links_by_target(seg0)
        )
        if link_ids.shape[0] == 0:
            break
        best_link, best_common = INVALID, 0
        for li in link_ids:
            li = int(li)
            if m3.link_separation[li] < MIN_LINK_SEPARATION:
                continue
            common = conn.analyze_segment_link_pair(reference, li)
            if common > best_common:
                best_link, best_common = li, common
        if best_common < MIN_COMMON_FOR_LINK:
            break
        seg1 = int(
            m3.link_target[best_link]
            if direction == 0
            else m3.link_source[best_link]
        )
        if stop_at_first_primary:
            if seg1 in previous_segments:
                break
            previous_segments.add(seg1)
        else:
            if (reference, seg1) in previous_pairs:
                break
            previous_pairs.add((reference, seg1))
            last_iteration.append(seg1)

        if direction == 0:
            info = conn.analyze_segment_pair(reference, seg1)
        else:
            info = conn.analyze_segment_pair(seg1, reference)
        jaccard_ok = conn.raw_jaccard(info) >= MIN_JACCARD or (
            MIN_JACCARD_CORRECTED is not None
            and info.jaccard() >= MIN_JACCARD_CORRECTED
        )
        if (
            info.common_count >= MIN_COMMON_FOR_PRIMARY
            and jaccard_ok
            and (candidate_mask is None or candidate_mask[seg1])
        ):
            if stop_at_first_primary:
                intermediates = [
                    s.id for s in segments[1:]
                ]  # excludes start and seg1
                jaccard_edge = (seg1, info, intermediates)
                break
            # New primary.
            last_primary = segments[-1].id
            for sid in last_iteration:
                s = PathSegment(sid, False)
                if sid != seg1:
                    if direction == 0:
                        s.previous_primary = last_primary
                        s.next_primary = seg1
                    else:
                        s.previous_primary = seg1
                        s.next_primary = last_primary
                segments.append(s)
            segments[-1].is_primary = True
            last_iteration = []
            reference = seg1
        elif stop_at_first_primary:
            segments.append(PathSegment(seg1, False))
        seg0 = seg1
    if stop_at_first_primary:
        return jaccard_edge
    return segments


def create_assembly_path(
    conn: Mode3Connectivity, start: int, direction: int
) -> List[PathSegment]:
    """(reference: createAssemblyPath, src/mode3.cpp:1924). Returns
    the path segments in walk order (direction 1 returns them
    backward, as the reference does)."""
    return _walk(conn, start, direction, stop_at_first_primary=False)


@dataclass
class JaccardEdge:
    seg0: int
    seg1: int
    jaccard: float
    raw_jaccard: float
    common: int
    intermediates: List[int]
    found_forward: bool = False
    found_backward: bool = False

    @property
    def is_strong(self) -> bool:
        return self.found_forward and self.found_backward


def create_jaccard_graph(
    conn: Mode3Connectivity,
    candidate_mask: Optional[np.ndarray] = None,
) -> Dict[Tuple[int, int], JaccardEdge]:
    """One forward + one backward search per segment (reference:
    createJaccardGraph, src/mode3-JaccardGraph.cpp:28). With a
    ``candidate_mask``, searches start only from masked-in segments
    and may only end at masked-in segments (masked-out segments pass
    through as intermediates)."""
    edges: Dict[Tuple[int, int], JaccardEdge] = {}
    for seg in range(conn.m3.segment_count):
        if candidate_mask is not None and not candidate_mask[seg]:
            continue
        for direction in (0, 1):
            found = _walk(
                conn, seg, direction, stop_at_first_primary=True,
                candidate_mask=candidate_mask,
            )
            if found is None:
                continue
            other, info, intermediates = found
            if direction == 0:
                key = (seg, other)
            else:
                key = (other, seg)
                intermediates = list(reversed(intermediates))
            e = edges.get(key)
            if e is None:
                e = JaccardEdge(
                    key[0], key[1], info.jaccard(), conn.raw_jaccard(info),
                    info.common_count, intermediates,
                )
                edges[key] = e
            if direction == 0:
                e.found_forward = True
            else:
                e.found_backward = True
    return edges


def create_jaccard_graph_iterative(
    conn: Mode3Connectivity,
    max_iterations: int = 4,
) -> Tuple[Dict[Tuple[int, int], JaccardEdge], np.ndarray]:
    """Iterative Jaccard-graph construction with weak-vertex cleanup
    (the reference ships this machinery — JaccardGraph::
    isStrongVertex / removeWeakVertices,
    src/mode3-JaccardGraph.cpp:238-296 — guarded off in
    createJaccardGraph; here it runs as designed and then RE-RUNS the
    directional searches with removed vertices demoted to
    pass-through intermediates, so strong edges re-form across weak
    segments and chains reconnect). A vertex is weak when it has
    incident edges but none strong (found in both directions).
    Returns (edges, candidate_mask) — the mask marks surviving
    (strong or edge-less) segments after the final pass."""
    n_seg = conn.m3.segment_count
    mask = np.ones(n_seg, bool)
    edges = create_jaccard_graph(conn)
    for _ in range(max_iterations - 1):
        has_edge = np.zeros(n_seg, bool)
        strong = np.zeros(n_seg, bool)
        for e in edges.values():
            has_edge[e.seg0] = has_edge[e.seg1] = True
            if e.is_strong:
                strong[e.seg0] = strong[e.seg1] = True
        weak = mask & has_edge & ~strong
        if not weak.any():
            break
        mask &= ~weak
        edges = create_jaccard_graph(conn, candidate_mask=mask)
    return edges, mask


def find_jaccard_clusters(
    n_seg: int,
    edges: Dict[Tuple[int, int], JaccardEdge],
    min_cluster_size: int = 5,
) -> np.ndarray:
    """Connected components of the Jaccard graph, numbered by
    decreasing size (reference: JaccardGraph::findClusters,
    src/mode3-JaccardGraph.cpp:404)."""
    parent = list(range(n_seg))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (s0, s1) in edges:
        ra, rb = find(s0), find(s1)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    comps: Dict[int, List[int]] = {}
    for s in range(n_seg):
        comps.setdefault(find(s), []).append(s)
    table = sorted(
        (c for c in comps.values() if len(c) >= min_cluster_size),
        key=len, reverse=True,
    )
    cluster_ids = np.full(n_seg, INVALID, np.int64)
    for cid, members in enumerate(table):
        cluster_ids[np.asarray(members)] = cid
    return cluster_ids


def find_jaccard_paths(
    n_seg: int, edges: Dict[Tuple[int, int], JaccardEdge]
) -> List[List[PathSegment]]:
    """Chain strong Jaccard edges into maximal linear paths; the
    intermediates of each edge become secondary segments between its
    primary endpoints (the chains the reference's ExpandedJaccardGraph
    materializes, src/mode3-JaccardGraph.cpp:471)."""
    strong = [e for e in edges.values() if e.is_strong]

    def better(a: JaccardEdge, b: Optional[JaccardEdge], other_attr: str):
        """Deterministic preference: higher common count, then lower
        other-endpoint id."""
        if b is None:
            return True
        if a.common != b.common:
            return a.common > b.common
        return getattr(a, other_attr) < getattr(b, other_attr)

    # Mutual selection: keep an edge only when it is BOTH the best
    # out-edge of its source and the best in-edge of its target. The
    # result has out-degree <= 1 AND in-degree <= 1 everywhere, so the
    # chains are simple paths (plus possible cycles) and no chain can
    # be truncated by another's traversal — the round-3 greedy chainer
    # marked visited targets and cut ~12% of chain ends short.
    best_out: Dict[int, JaccardEdge] = {}
    best_in: Dict[int, JaccardEdge] = {}
    for e in strong:
        if better(e, best_out.get(e.seg0), "seg1"):
            best_out[e.seg0] = e
        if better(e, best_in.get(e.seg1), "seg0"):
            best_in[e.seg1] = e
    out_edge = {
        s: e for s, e in best_out.items() if best_in.get(e.seg1) is e
    }
    has_in = {e.seg1 for e in out_edge.values()}

    paths: List[List[PathSegment]] = []
    used = set()

    def emit_chain(start: int) -> None:
        path = [PathSegment(start, True)]
        used.add(start)
        cur = start
        while cur in out_edge:
            e = out_edge[cur]
            if e.seg1 in used:  # cycle closes back on this chain
                break
            for mid in e.intermediates:
                s = PathSegment(mid, False)
                s.previous_primary = e.seg0
                s.next_primary = e.seg1
                path.append(s)
            path.append(PathSegment(e.seg1, True))
            used.add(e.seg1)
            cur = e.seg1
        if len(path) > 1:
            paths.append(path)

    for s in sorted(out_edge):
        if s not in used and s not in has_in:
            emit_chain(s)
    for s in sorted(out_edge):  # circular leftovers, cut at min id
        if s not in used:
            emit_chain(s)
    return paths


# ---------------------------------------------------------------------------
# Path assembly
# ---------------------------------------------------------------------------


class PathAssembler:
    """Assembles AssemblyPaths: segments via the shared chain
    assembler, links via anchored MSA (reference:
    AssemblyPath::assemble, src/mode3-AssemblyPath.cpp:28)."""

    def __init__(
        self,
        m3: Mode3Graph,
        conn: Mode3Connectivity,
        mg: MarkerGraph,
        markers: MarkerStore,
        reads: ReadStore,
        vertex_repeats: np.ndarray,
        edge_consensus,
        caller=None,
    ):
        from shasta_tpu_torch.consensus.caller import ModalConsensusCaller

        self.m3 = m3
        self.conn = conn
        self.mg = mg
        self.markers = markers
        self.reads = reads
        self.vertex_repeats = vertex_repeats
        self.edge_consensus = edge_consensus
        self.caller = caller or ModalConsensusCaller()
        self.k = markers.k
        self._kmer_first = (
            markers.kmer_ids[mg.vertex_markers[mg.vertex_offsets[:-1]]]
            if mg.vertex_count
            else np.zeros(0, np.uint32)
        )
        self._vertex_cov = mg.vertex_coverage()

    def assemble_segment(self, seg: PathSegment) -> None:
        from shasta_tpu_torch.graph.assembly_graph import assemble_chain

        chain = self.m3.ag.chain(seg.id)
        rle, rep, _raw, v_off = assemble_chain(
            self.mg, self.markers, self.vertex_repeats,
            self.edge_consensus, chain,
            kmer_first=self._kmer_first, vertex_cov=self._vertex_cov,
            with_offsets=True,
        )
        seg.rle, seg.rep, seg.vertex_offsets = rle, rep, v_off

    def assemble_path(self, segments: List[PathSegment]) -> AssemblyPath:
        path = AssemblyPath(segments=segments)
        for s in segments:
            self.assemble_segment(s)
        if len(segments) > 1:
            self._initialize_links(path)
            self._assemble_links(path)
        self._stitch(path)
        return path

    # ----- links -----

    def _initialize_links(self, path: AssemblyPath) -> None:
        """(reference: initializeLinks, src/mode3-AssemblyPath.cpp:57)"""
        m3 = self.m3
        path.links = []
        for i in range(len(path.segments) - 1):
            s0, s1 = path.segments[i], path.segments[i + 1]
            lid = self.conn.find_link(s0.id, s1.id)
            if lid == INVALID:
                # No link: treat as trivial junction with no trims.
                path.links.append(PathLink(INVALID, True))
                continue
            path.links.append(PathLink(lid, bool(m3.link_adjacent[lid])))
        last_primary = path.segments[0].id
        for i, link in enumerate(path.links):
            if path.segments[i].is_primary:
                last_primary = path.segments[i].id
            link.previous_primary = last_primary
        next_primary = path.segments[-1].id
        for i in range(len(path.links) - 1, -1, -1):
            if path.segments[i + 1].is_primary:
                next_primary = path.segments[i + 1].id
            path.links[i].next_primary = next_primary

    def _assemble_links(self, path: AssemblyPath) -> None:
        path.segments[0].left_trim = 0
        path.segments[-1].right_trim = 0
        for i, link in enumerate(path.links):
            s0, s1 = path.segments[i], path.segments[i + 1]
            if link.id == INVALID or link.is_trivial:
                # Adjacent in the marker graph: split the shared
                # vertex k/2 + k/2 (reference: assembleTrivialLink,
                # src/mode3-AssemblyPath.cpp:425).
                s0.right_trim = self.k // 2
                s1.left_trim = self.k // 2
            else:
                self._assemble_nontrivial_link(s0, s1, link)

    def _assemble_nontrivial_link(
        self, s0: PathSegment, s1: PathSegment, link: PathLink
    ) -> None:
        """(reference: assembleNonTrivialLink,
        src/mode3-AssemblyPath.cpp:181)"""
        from shasta_tpu_torch.consensus.msa import poa_msa

        m3, k = self.m3, self.k
        lo, hi = m3.transition_offsets[link.id], m3.transition_offsets[link.id + 1]
        orids = m3.t_orid[lo:hi]
        pos0s = m3.t_pos0[lo:hi]
        ord0s = m3.t_ord0[lo:hi]
        pos1s = m3.t_pos1[lo:hi]
        ord1s = m3.t_ord1[lo:hi]

        # Keep transitions of reads on an adjacent primary segment.
        keep = np.array(
            [
                self.conn.segment_contains_orid(link.previous_primary, int(o))
                or self.conn.segment_contains_orid(link.next_primary, int(o))
                for o in orids
            ],
            dtype=bool,
        )
        if not keep.any():
            keep = np.ones(orids.shape[0], dtype=bool)
        orids, pos0s, ord0s = orids[keep], pos0s[keep], ord0s[keep]
        pos1s, ord1s = pos1s[keep], ord1s[keep]

        min_edge_pos0 = int(pos0s.min())
        max_edge_pos1 = int(pos1s.max())
        min_vertex_pos0 = min_edge_pos0 + 1
        max_vertex_pos1 = max_edge_pos1

        seqs: List[np.ndarray] = []
        reps: List[np.ndarray] = []
        used_orids: List[int] = []
        for t in range(orids.shape[0]):
            orid = int(orids[t])
            read_id, strand = orid // 2, orid % 2
            mlo = self.markers.offsets[orid]
            # Marker RLE positions on the oriented read.
            p0 = int(self.markers.positions[mlo + int(ord0s[t])])
            p1 = int(self.markers.positions[mlo + int(ord1s[t])])
            if p1 < p0:
                continue
            rle = self.reads.read_rle(read_id, strand)
            rep = self.reads.read_repeat_counts(read_id, strand)
            mid_s = rle[p0 : p1 + k]
            mid_r = rep[p0 : p1 + k].astype(np.int32)

            # Left extension from segment 0 (vertex coordinates).
            v_pos0 = int(pos0s[t]) + 1
            b0 = int(s0.vertex_offsets[min_vertex_pos0])
            e0 = int(s0.vertex_offsets[v_pos0])
            left_s = s0.rle[b0:e0]
            left_r = s0.rep[b0:e0]
            # Right extension from segment 1.
            v_pos1 = int(pos1s[t])
            b1 = int(s1.vertex_offsets[v_pos1]) + k
            e1 = int(s1.vertex_offsets[max_vertex_pos1]) + k
            right_s = s1.rle[b1:e1]
            right_r = s1.rep[b1:e1]

            seqs.append(np.concatenate([left_s, mid_s, right_s]).astype(np.uint8))
            reps.append(np.concatenate([left_r, mid_r, right_r]))
            used_orids.append(orid)

        link.coverage = len(seqs)
        if not seqs:
            link.msa_rle = np.zeros(0, np.uint8)
            link.msa_rep = np.zeros(0, np.int32)
            return

        # Anchored MSA + per-column consensus (reference:
        # computeLinkConsensusUsingSpoa, src/mode3-AssemblyPath.cpp:553).
        rows = poa_msa(seqs)
        width = rows[0].shape[0]
        n = len(rows)
        rep_rows = np.zeros((n, width), np.int32)
        for i, row in enumerate(rows):
            sel = row != 4
            rep_rows[i, sel] = reps[i]
        base_mat = np.stack(rows)
        cons_s: List[int] = []
        cons_r: List[int] = []
        for c in range(width):
            b, r = self.caller(base_mat[:, c], rep_rows[:, c])
            if b != 4:
                cons_s.append(int(b))
                cons_r.append(max(int(r), 1))
        msa_rle = np.array(cons_s, np.uint8)
        msa_rep = np.array(cons_r, np.int32)

        # Identical-flank trims (reference: assembleNonTrivialLink
        # trailing section, src/mode3-AssemblyPath.cpp:366-421).
        begin0 = int(s0.vertex_offsets[min_vertex_pos0])
        seg0_tail = s0.rle[begin0:]
        n_cmp = min(seg0_tail.shape[0], msa_rle.shape[0])
        identical_left = 0
        while (
            identical_left < n_cmp
            and msa_rle[identical_left] == seg0_tail[identical_left]
        ):
            identical_left += 1

        end1 = int(s1.vertex_offsets[max_vertex_pos1]) + self.k
        seg1_head = s1.rle[:end1]
        n_cmp = min(seg1_head.shape[0], msa_rle.shape[0] - identical_left)
        identical_right = 0
        while (
            identical_right < n_cmp
            and msa_rle[msa_rle.shape[0] - 1 - identical_right]
            == seg1_head[seg1_head.shape[0] - 1 - identical_right]
        ):
            identical_right += 1

        link.msa_rle = msa_rle
        link.msa_rep = msa_rep
        link.left_trim = identical_left
        link.right_trim = identical_right
        s0.right_trim = s0.rle.shape[0] - begin0 - identical_left
        s1.left_trim = end1 - identical_right

    # ----- stitch -----

    def _stitch(self, path: AssemblyPath) -> None:
        """(reference: AssemblyPath::assemble,
        src/mode3-AssemblyPath.cpp:819)"""
        rle_parts: List[np.ndarray] = []
        rep_parts: List[np.ndarray] = []
        total = 0
        for i, seg in enumerate(path.segments):
            lt, rt = seg.left_trim, seg.right_trim
            n = seg.rle.shape[0]
            if lt + rt > n:
                # Overlapping trims: remove the excess from what is
                # already assembled (reference: excessTrim handling).
                excess = lt + rt - n
                while excess > 0 and rle_parts:
                    last = rle_parts[-1]
                    cut = min(excess, last.shape[0])
                    rle_parts[-1] = last[: last.shape[0] - cut]
                    rep_parts[-1] = rep_parts[-1][: last.shape[0] - cut]
                    excess -= cut
                    if rle_parts[-1].shape[0] == 0:
                        rle_parts.pop()
                        rep_parts.pop()
            else:
                rle_parts.append(seg.rle[lt : n - rt])
                rep_parts.append(seg.rep[lt : n - rt])
            if i < len(path.links):
                link = path.links[i]
                if link.msa_rle is not None and link.msa_rle.shape[0]:
                    m = link.msa_rle.shape[0]
                    rle_parts.append(
                        link.msa_rle[link.left_trim : m - link.right_trim]
                    )
                    rep_parts.append(
                        link.msa_rep[link.left_trim : m - link.right_trim]
                    )
        path.rle = (
            np.concatenate(rle_parts) if rle_parts else np.zeros(0, np.uint8)
        )
        path.rep = (
            np.concatenate(rep_parts).astype(np.int32)
            if rep_parts
            else np.zeros(0, np.int32)
        )
        path.rep = np.maximum(path.rep, 1)
        path.raw = np.repeat(path.rle, path.rep)
        _ = total


# ---------------------------------------------------------------------------
# Output writers
# ---------------------------------------------------------------------------

def write_paths_fasta(path: str, paths: List[AssemblyPath]) -> None:
    from shasta_tpu_torch.graph.assembly_graph import _seq_str

    with open(path, "w") as f:
        for i, p in enumerate(paths):
            seq = _seq_str(p.raw) if p.raw is not None else ""
            segs = "-".join(str(s.id) for s in p.segments)
            f.write(f">P{i} length={len(seq)} segments={segs}\n{seq}\n")


def write_jaccard_edges_csv(
    path: str, edges: Dict[Tuple[int, int], JaccardEdge]
) -> None:
    """(reference: JaccardGraph::writeEdgesCsv,
    src/mode3-JaccardGraph.cpp:373)"""
    with open(path, "w") as f:
        f.write("SegmentId0,SegmentId1,Jaccard,RawJaccard,Common,Strong,Intermediates\n")
        for (s0, s1), e in sorted(edges.items()):
            mids = " ".join(str(m) for m in e.intermediates)
            f.write(
                f"{s0},{s1},{e.jaccard:.4f},{e.raw_jaccard:.4f},"
                f"{e.common},{'Yes' if e.is_strong else 'No'},{mids}\n"
            )
