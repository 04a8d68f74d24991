"""The read graph: oriented reads as vertices, selected alignments as edges.

Counterpart of the reference read graph
(reference: src/ReadGraph.hpp:36-56, src/AssemblerReadGraph.cpp:35-240).
Vertices are oriented reads (2 per read); every kept alignment
generates an RC pair of edges (edge 2i+1 is the strand-flipped mirror
of edge 2i, a property downstream stages exploit the same way the
reference does at src/AssemblerMarkerGraph.cpp:540-559).

Construction method 0 (the default, createReadGraph at
src/AssemblerReadGraph.cpp:35): for each read keep the best
``max_alignment_count`` alignments by decreasing aligned-marker count;
an alignment survives if either of its reads keeps it. The selection
is a pure sort/segment computation here (no per-read loop), the same
shape the sharded multi-host path uses.

Chimera detection (flagChimericReads at
src/AssemblerReadGraph.cpp:355): for each read, BFS to
``max_chimeric_read_distance``; the read is chimeric if the vertices
at maximum distance fall in more than one connected component once
all edges touching the start read (either strand) are removed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from shasta_tpu_torch.ops.align import AlignmentStore


@dataclass
class ReadGraph:
    """Edges come in RC pairs: edge 2i+1 is edge 2i with both strands
    flipped (reference: src/AssemblerReadGraph.cpp:128-141)."""

    orid0: np.ndarray  # int64 [n_edges] oriented read id, orid0 < orid1
    orid1: np.ndarray  # int64 [n_edges]
    alignment_id: np.ndarray  # int64 [n_edges] (shared by the RC pair)
    crosses_strands: np.ndarray  # bool [n_edges]
    n_oriented_reads: int
    # CSR adjacency: edge ids incident to each oriented read.
    adj_offsets: np.ndarray = None  # int64 [n_or+1]
    adj_edges: np.ndarray = None  # int64 [total incidences]
    # hasInconsistentAlignment flag (reference: ReadGraph.hpp:36-56);
    # set by flag_inconsistent_alignments.
    inconsistent: np.ndarray = None  # bool [n_edges]

    def __post_init__(self):
        if self.adj_offsets is None:
            self._build_adjacency()
        if self.inconsistent is None:
            self.inconsistent = np.zeros(self.edge_count, dtype=bool)

    def _build_adjacency(self) -> None:
        n_or = self.n_oriented_reads
        ends = np.concatenate([self.orid0, self.orid1])
        eids = np.concatenate(
            [np.arange(self.edge_count, dtype=np.int64)] * 2
        )
        order = np.argsort(ends, kind="stable")
        self.adj_edges = eids[order]
        counts = np.bincount(ends, minlength=n_or)
        self.adj_offsets = np.zeros(n_or + 1, dtype=np.int64)
        np.cumsum(counts, out=self.adj_offsets[1:])

    @property
    def edge_count(self) -> int:
        return self.orid0.shape[0]

    def neighbors(self, orid: int) -> Tuple[np.ndarray, np.ndarray]:
        """(edge ids, other endpoints) incident to an oriented read."""
        lo, hi = self.adj_offsets[orid], self.adj_offsets[orid + 1]
        e = self.adj_edges[lo:hi]
        other = np.where(self.orid0[e] == orid, self.orid1[e], self.orid0[e])
        return e, other

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "orid0": self.orid0,
            "orid1": self.orid1,
            "alignment_id": self.alignment_id,
            "crosses_strands": self.crosses_strands,
            "n_oriented_reads": np.int64(self.n_oriented_reads),
            "inconsistent": self.inconsistent,
        }

    @classmethod
    def from_arrays(cls, a) -> "ReadGraph":
        inc = a["inconsistent"].copy() if "inconsistent" in a else None
        return cls(
            orid0=a["orid0"],
            orid1=a["orid1"],
            alignment_id=a["alignment_id"],
            crosses_strands=a["crosses_strands"].copy(),
            n_oriented_reads=int(a["n_oriented_reads"]),
            inconsistent=inc,
        )


def select_alignments_knn(
    alignments: AlignmentStore, n_reads: int, max_alignment_count: int
) -> np.ndarray:
    """Method-0 alignment selection (reference:
    src/AssemblerReadGraph.cpp:57-100): per read keep the
    ``max_alignment_count`` alignments with most aligned markers; an
    alignment is kept if either read keeps it. Ties break by lower
    alignment id (deterministic, unlike the reference's nth_element).

    Returns keep: bool [n_alignments].
    """
    n = alignments.count
    if n == 0:
        return np.zeros(0, dtype=bool)
    # Incidences: each alignment appears once per involved read.
    inc_read = np.concatenate([alignments.read_id0, alignments.read_id1])
    inc_aid = np.concatenate([np.arange(n, dtype=np.int64)] * 2)
    inc_mc = np.concatenate([alignments.marker_count] * 2)

    # Sort by (read, -marker_count, alignment_id).
    order = np.lexsort((inc_aid, -inc_mc.astype(np.int64), inc_read))
    sread = inc_read[order]
    # Rank within read.
    read_start_idx = np.concatenate(
        ([0], np.cumsum(np.bincount(sread, minlength=n_reads)))
    )
    rank = np.arange(sread.shape[0], dtype=np.int64) - read_start_idx[sread]
    keep_inc = rank < max_alignment_count

    keep = np.zeros(n, dtype=bool)
    keep[inc_aid[order][keep_inc]] = True
    return keep


def build_read_graph(
    alignments: AlignmentStore, n_reads: int, keep: np.ndarray
) -> ReadGraph:
    """Create RC-paired edges from the kept alignments (reference:
    src/AssemblerReadGraph.cpp:107-141)."""
    kept = np.flatnonzero(keep)
    n_kept = kept.shape[0]

    r0 = alignments.read_id0[kept].astype(np.int64)
    r1 = alignments.read_id1[kept].astype(np.int64)
    same = alignments.same_strand[kept]

    # Direct edge: (r0, 0) -- (r1, same ? 0 : 1); RC edge flips strands.
    e0_a = r0 * 2
    e0_b = r1 * 2 + np.where(same, 0, 1)
    e1_a = r0 * 2 + 1
    e1_b = r1 * 2 + np.where(same, 1, 0)

    orid0 = np.empty(2 * n_kept, dtype=np.int64)
    orid1 = np.empty(2 * n_kept, dtype=np.int64)
    orid0[0::2] = np.minimum(e0_a, e0_b)
    orid1[0::2] = np.maximum(e0_a, e0_b)
    orid0[1::2] = np.minimum(e1_a, e1_b)
    orid1[1::2] = np.maximum(e1_a, e1_b)

    alignment_id = np.repeat(kept, 2)

    return ReadGraph(
        orid0=orid0,
        orid1=orid1,
        alignment_id=alignment_id,
        crosses_strands=np.zeros(2 * n_kept, dtype=bool),
        n_oriented_reads=2 * n_reads,
    )


def create_read_graph(
    alignments: AlignmentStore,
    n_reads: int,
    max_alignment_count: int = 6,
) -> Tuple[ReadGraph, np.ndarray]:
    """Method-0 read graph creation. Returns (graph, keep_alignment)."""
    keep = select_alignments_knn(alignments, n_reads, max_alignment_count)
    return build_read_graph(alignments, n_reads, keep), keep


def _histogram_threshold(
    values: np.ndarray, start: float, stop: float, bins: int, fraction: float
) -> float:
    """Reference Histogram2.thresholdByCumulativeProportion
    (src/Histogram.cpp:122-140): the center of the first bin where the
    cumulative fraction reaches ``fraction``; values beyond ``stop``
    land in the last (unbounded-right) bin."""
    if values.shape[0] == 0:
        return start
    bin_size = (stop - start) / bins
    idx = np.clip(((values - start) / bin_size).astype(np.int64), 0, bins - 1)
    hist = np.bincount(idx, minlength=bins)
    cum = np.cumsum(hist) / hist.sum()
    i = int(np.searchsorted(cum, fraction))
    i = min(i, bins - 1)
    return start + bin_size * i + bin_size / 2


def compute_read_graph2_criteria(
    alignments: AlignmentStore,
    marker_count_percentile: float = 0.015,
    aligned_fraction_percentile: float = 0.12,
    max_skip_percentile: float = 0.12,
    max_drift_percentile: float = 0.12,
    max_trim_percentile: float = 0.015,
) -> Dict[str, float]:
    """Adaptive alignment criteria from the observed distributions
    (reference: setReadGraph2Criteria, src/AssemblerReadGraph2.cpp:94):
    histograms with the reference's exact bin layouts; minimum
    thresholds use the percentile, maximums use 1 - percentile."""
    trim = np.maximum(alignments.left_trim(), alignments.right_trim())
    return {
        "min_aligned_fraction": _histogram_threshold(
            alignments.aligned_fraction_min(), 0, 1, 100, aligned_fraction_percentile
        ),
        "min_aligned_marker_count": round(
            _histogram_threshold(
                alignments.marker_count.astype(np.float64),
                0,
                3000,
                300,
                marker_count_percentile,
            )
        ),
        "max_drift": round(
            _histogram_threshold(
                alignments.max_drift_v.astype(np.float64),
                0,
                100,
                100,
                1 - max_drift_percentile,
            )
        ),
        "max_skip": round(
            _histogram_threshold(
                alignments.max_skip_v.astype(np.float64),
                0,
                100,
                100,
                1 - max_skip_percentile,
            )
        ),
        "max_trim": round(
            _histogram_threshold(
                trim.astype(np.float64), 0, 100, 100, 1 - max_trim_percentile
            )
        ),
    }


def create_read_graph2(
    alignments: AlignmentStore,
    n_reads: int,
    max_alignment_count: int = 6,
    marker_count_percentile: float = 0.015,
    aligned_fraction_percentile: float = 0.12,
    max_skip_percentile: float = 0.12,
    max_drift_percentile: float = 0.12,
    max_trim_percentile: float = 0.015,
) -> Tuple[ReadGraph, np.ndarray, Dict[str, float]]:
    """Method-2 read graph creation (reference: createReadGraph2,
    src/AssemblerReadGraph2.cpp:182): filter alignments by the
    adaptive criteria, then per-read kNN like method 0."""
    criteria = compute_read_graph2_criteria(
        alignments,
        marker_count_percentile,
        aligned_fraction_percentile,
        max_skip_percentile,
        max_drift_percentile,
        max_trim_percentile,
    )
    trim = np.maximum(alignments.left_trim(), alignments.right_trim())
    passes = (
        (alignments.aligned_fraction_min() >= criteria["min_aligned_fraction"])
        & (alignments.marker_count >= criteria["min_aligned_marker_count"])
        & (alignments.max_drift_v <= criteria["max_drift"])
        & (alignments.max_skip_v <= criteria["max_skip"])
        & (trim <= criteria["max_trim"])
    )

    # kNN over the passing alignments only.
    n = alignments.count
    inc_read = np.concatenate([alignments.read_id0, alignments.read_id1])
    inc_aid = np.concatenate([np.arange(n, dtype=np.int64)] * 2)
    inc_mc = np.concatenate([alignments.marker_count] * 2)
    ok = passes[inc_aid]
    inc_read, inc_aid, inc_mc = inc_read[ok], inc_aid[ok], inc_mc[ok]

    keep = np.zeros(n, dtype=bool)
    if inc_aid.shape[0]:
        order = np.lexsort((inc_aid, -inc_mc.astype(np.int64), inc_read))
        sread = inc_read[order]
        read_start_idx = np.concatenate(
            ([0], np.cumsum(np.bincount(sread, minlength=n_reads)))
        )
        rank = np.arange(sread.shape[0], dtype=np.int64) - read_start_idx[sread]
        keep_inc = rank < max_alignment_count
        keep[inc_aid[order][keep_inc]] = True

    return build_read_graph(alignments, n_reads, keep), keep, criteria


# ---------------------------------------------------------------------------
# Chimera flagging
# ---------------------------------------------------------------------------


class _DSU:
    __slots__ = ("parent",)

    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def flag_chimeric_reads(
    graph: ReadGraph, n_reads: int, max_distance: int = 2
) -> np.ndarray:
    """Flag chimeric reads (reference: src/AssemblerReadGraph.cpp:355-580).

    For each read: BFS from (read, 0) to ``max_distance`` (skipping
    cross-strand edges); union local vertices over edges that avoid the
    start read entirely; the read is chimeric if the max-distance
    frontier spans more than one component.

    Returns is_chimeric: bool [n_reads].
    """
    if max_distance == 0:
        return np.zeros(n_reads, dtype=bool)

    from shasta_tpu_torch import native

    return native.flag_chimeric_native(graph, n_reads, max_distance)


def flag_cross_strand_edges2(
    graph: ReadGraph,
    alignments: AlignmentStore,
    n_reads: int,
    is_chimeric: Optional[np.ndarray] = None,
) -> int:
    """Strand separation method 2 (reference:
    flagCrossStrandReadGraphEdges2, src/AssemblerReadGraph.cpp:1051):
    process RC edge pairs in decreasing aligned-marker order over a
    union-find of oriented reads; a pair whose addition would merge a
    component with its own reverse complement is flagged cross-strand
    and not added. Guarantees (for the used edges) that the two
    strands of every read end up in different components.

    Sets graph.crosses_strands in place; returns the flagged count.
    """
    pairs = np.arange(0, graph.edge_count, 2, dtype=np.int64)
    aids = graph.alignment_id[pairs]
    mc = alignments.marker_count[aids]
    ok = np.ones(pairs.shape[0], dtype=bool)
    if is_chimeric is not None:
        ok &= ~is_chimeric[alignments.read_id0[aids]]
        ok &= ~is_chimeric[alignments.read_id1[aids]]
    pairs, mc = pairs[ok], mc[ok]
    # Decreasing marker count; ties by edge id ascending (matches the
    # reference's per-bucket insertion order).
    order = np.lexsort((pairs, -mc.astype(np.int64)))
    ordered = pairs[order]

    # Native sequential DSU sweep (the ordering above is the
    # vectorized part; the sweep itself is inherently sequential).
    from shasta_tpu_torch import native

    return native.cross_strand_edges2_native(graph, ordered)


def connected_components_excluding_cross(graph: ReadGraph) -> np.ndarray:
    """Connected components over non-cross-strand edges only."""
    n = graph.n_oriented_reads
    keep = ~graph.crosses_strands
    label = np.arange(n, dtype=np.int64)
    a = graph.orid0[keep]
    b = graph.orid1[keep]
    while True:
        m = np.minimum(label[a], label[b])
        new = label.copy()
        np.minimum.at(new, a, m)
        np.minimum.at(new, b, m)
        new = new[new]
        if np.array_equal(new, label):
            return label
        label = new


def connected_components(graph: ReadGraph) -> np.ndarray:
    """Connected components over oriented reads (informational, like
    reference computeReadGraphConnectedComponents). Returns component
    label per oriented read (min oriented read id in component)."""
    n = graph.n_oriented_reads
    label = np.arange(n, dtype=np.int64)
    a = graph.orid0
    b = graph.orid1
    while True:
        la = label[a]
        lb = label[b]
        m = np.minimum(la, lb)
        new = label.copy()
        np.minimum.at(new, a, m)
        np.minimum.at(new, b, m)
        # Pointer jumping.
        new = new[new]
        if np.array_equal(new, label):
            return label
        label = new


# ---------------------------------------------------------------------------
# Strand separation method 1 (local strand-jump regions)
# ---------------------------------------------------------------------------


def flag_cross_strand_edges1(
    graph: ReadGraph,
    alignments: AlignmentStore,
    n_reads: int,
    max_distance: int = 6,
) -> int:
    """Strand separation method 1 (reference:
    flagCrossStrandReadGraphEdges1, src/AssemblerReadGraph.cpp:775-1011).

    1. A vertex is "near a strand jump" if its reverse complement is
       reachable within ``max_distance`` edges.
    2. Connected components of the subgraph induced by such vertices
       are strand-jump regions.
    3. Within each region, RC edge pairs are processed in decreasing
       aligned-marker order over a local union-find that tracks each
       vertex and its reverse complement; an edge whose addition would
       make a vertex reachable from its own reverse complement is
       flagged cross-strand and withheld.

    Clears and then sets graph.crosses_strands; returns flagged count.
    """
    graph.crosses_strands[:] = False
    if max_distance == 0:
        return 0
    n_or = graph.n_oriented_reads

    from shasta_tpu_torch import native

    near = native.near_strand_jump_native(graph, n_reads, max_distance)

    if not near.any():
        return 0

    # Components of the near-strand-jump subgraph.
    both = near[graph.orid0] & near[graph.orid1]
    label = np.arange(n_or, dtype=np.int64)
    a, b = graph.orid0[both], graph.orid1[both]
    while True:
        m = np.minimum(label[a], label[b])
        new = label.copy()
        np.minimum.at(new, a, m)
        np.minimum.at(new, b, m)
        new = new[new]
        if np.array_equal(new, label):
            break
        label = new

    flagged = 0
    roots = np.unique(label[near])
    for root in roots:
        vertices = np.flatnonzero(near & (label == root))
        # Close the region under reverse complement (the reference
        # asserts self-complementarity; we enforce it).
        vertices = np.unique(np.concatenate([vertices, vertices ^ 1]))
        if vertices.shape[0] < 2:
            continue
        vmap = {int(v): i for i, v in enumerate(vertices)}

        # Gather direct edges inside the region (the even edge of each
        # RC pair), with their marker counts.
        region_edges = []
        for v0 in vertices:
            lo, hi = graph.adj_offsets[v0], graph.adj_offsets[v0 + 1]
            for ei in graph.adj_edges[lo:hi]:
                ei = int(ei)
                if ei % 2:
                    continue
                if graph.orid0[ei] != v0:
                    continue  # count each edge once
                other = int(graph.orid1[ei])
                if other not in vmap:
                    continue
                # Both mirror endpoints must be inside too (RC closure
                # of the region makes this automatic).
                region_edges.append(ei)
        if not region_edges:
            continue
        region_edges = np.asarray(region_edges, dtype=np.int64)
        mc = alignments.marker_count[graph.alignment_id[region_edges]]
        order = np.lexsort((region_edges, -mc.astype(np.int64)))

        dsu = _DSU(vertices.shape[0])
        for e in region_edges[order]:
            for ei in (int(e), int(e) + 1):
                p, q = int(graph.orid0[ei]), int(graph.orid1[ei])
                i0, i1 = vmap.get(p), vmap.get(q)
                if i0 is None or i1 is None:
                    continue  # mirror endpoint outside the region
                i0rc, i1rc = vmap[p ^ 1], vmap[q ^ 1]
                c0, c1 = dsu.find(i0), dsu.find(i1)
                c0rc, c1rc = dsu.find(i0rc), dsu.find(i1rc)
                if c0 == c1rc or c1 == c0rc:
                    graph.crosses_strands[ei] = True
                    flagged += 1
                else:
                    dsu.union(i0, i1)
                    dsu.union(i0rc, i1rc)
    return flagged


# ---------------------------------------------------------------------------
# Inconsistent-alignment flagging (triangle + least-squares analysis)
# ---------------------------------------------------------------------------


def edge_average_offsets(graph: ReadGraph, alignments: AlignmentStore) -> np.ndarray:
    """Per-edge average ordinal offset, oriented with the lowest
    oriented read first (reference: AlignmentInfo.averageOrdinalOffset
    used at src/AssemblerReadGraph.cpp:1888-1914).

    For edge endpoints (u, v) with u < v this is the mean of
    (ordinal_u - ordinal_v) over the alignment's matched marker pairs.
    """
    # Per-alignment mean offset in the canonical orientation
    # A = (read_id0, 0), B = (read_id1, same_strand ? 0 : 1).
    n = alignments.count
    counts = np.diff(alignments.offsets).astype(np.float64)
    diffs = alignments.ord0.astype(np.int64) - alignments.ord1.astype(np.int64)
    # Sentinel element so a zero-count alignment at the end produces a
    # valid reduceat index (its sum is masked out below anyway).
    diffs = np.concatenate([diffs, np.zeros(1, np.int64)])
    sums = (
        np.add.reduceat(diffs, alignments.offsets[:-1], dtype=np.int64)
        if n
        else np.zeros(0, np.int64)
    )
    sums = np.where(counts > 0, sums, 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        avg = np.where(counts > 0, sums / np.maximum(counts, 1.0), 0.0)
    # RC orientation (A^1, B^1): offset' = (n0 - n1) - offset.
    avg_rc = (
        alignments.n_markers0.astype(np.float64)
        - alignments.n_markers1.astype(np.float64)
        - avg
    )

    aid = graph.alignment_id
    A = (alignments.read_id0[aid].astype(np.int64) << 1)
    B = (alignments.read_id1[aid].astype(np.int64) << 1) + (
        ~alignments.same_strand[aid]
    ).astype(np.int64)
    p, q = graph.orid0, graph.orid1
    off = np.zeros(graph.edge_count, dtype=np.float64)
    case_ab = (p == A) & (q == B)
    case_ba = (p == B) & (q == A)
    case_rc = (p == (A ^ 1)) & (q == (B ^ 1))
    case_cr = (p == (B ^ 1)) & (q == (A ^ 1))
    off[case_ab] = avg[aid[case_ab]]
    off[case_ba] = -avg[aid[case_ba]]
    off[case_rc] = avg_rc[aid[case_rc]]
    off[case_cr] = -avg_rc[aid[case_cr]]
    # Orient lowest-first.
    return np.where(p <= q, off, -off)


def _local_neighborhood(
    graph: ReadGraph,
    seeds,
    max_distance: int,
    is_chimeric: Optional[np.ndarray],
    dead: np.ndarray,
):
    """Vertices within max_distance of the seeds plus the edges among
    them, excluding chimeric reads and dead (cross-strand or
    inconsistent) edges (reference: createLocalReadGraph,
    src/AssemblerLocalReadGraph.cpp semantics)."""
    orid0, orid1 = graph.orid0, graph.orid1
    adj_off, adj_e = graph.adj_offsets, graph.adj_edges
    verts = {int(s) for s in seeds}
    frontier = list(verts)
    for _ in range(max_distance):
        nxt = []
        for v0 in frontier:
            for ei in adj_e[adj_off[v0] : adj_off[v0 + 1]]:
                ei = int(ei)
                if dead[ei]:
                    continue
                v1 = int(orid1[ei]) if orid0[ei] == v0 else int(orid0[ei])
                if is_chimeric is not None and is_chimeric[v1 >> 1]:
                    continue
                if v1 not in verts:
                    verts.add(v1)
                    nxt.append(v1)
        frontier = nxt
        if not frontier:
            break
    edges = set()
    for v0 in verts:
        for ei in adj_e[adj_off[v0] : adj_off[v0 + 1]]:
            ei = int(ei)
            if dead[ei]:
                continue
            v1 = int(orid1[ei]) if orid0[ei] == v0 else int(orid0[ei])
            if v1 in verts:
                edges.add(ei & ~1)  # one id per RC pair's local instance
                edges.add(ei)
    return sorted(verts), sorted(edges)


def _least_square_positions(
    vertex_index: Dict[int, int],
    edge_list,
    graph: ReadGraph,
    edge_offsets: np.ndarray,
    sv_threshold: float = 1e-3,
) -> np.ndarray:
    """Min-norm least-squares vertex positions x with equations
    x_v - x_u = -offset(u,v) for u < v (reference: leastSquareAnalysis,
    src/AssemblerReadGraph.cpp:1544-1690; dgesvd replaced by numpy SVD
    with the same absolute singular-value threshold)."""
    N = len(vertex_index)
    M = len(edge_list)
    A = np.zeros((M, N), dtype=np.float64)
    B = np.zeros(M, dtype=np.float64)
    for i, ei in enumerate(edge_list):
        u, v = int(graph.orid0[ei]), int(graph.orid1[ei])
        if u > v:
            u, v = v, u
        j0, j1 = vertex_index[u], vertex_index[v]
        A[i, j0] = -1.0
        A[i, j1] = 1.0
        B[i] = -edge_offsets[ei]
    U, S, Vt = np.linalg.svd(A, full_matrices=False)
    inv = np.where(S > sv_threshold, 1.0 / np.maximum(S, sv_threshold), 0.0)
    return Vt.T @ (inv * (U.T @ B))


def flag_inconsistent_alignments(
    graph: ReadGraph,
    alignments: AlignmentStore,
    n_reads: int,
    is_chimeric: Optional[np.ndarray] = None,
    triangle_error_threshold: int = 200,
    least_square_error_threshold: int = 200,
    least_square_max_distance: int = 1,
) -> int:
    """Flag read-graph edges whose alignment offset is inconsistent
    (reference: flagInconsistentAlignments,
    src/AssemblerReadGraph.cpp:1826-2092, experimental
    --ReadGraph.removeConflicts path).

    For every triangle 0-1-2 (orid0 on strand 0, orid0<orid1<orid2,
    skipping chimeric reads and cross-strand edges) whose offset
    closure error exceeds ``triangle_error_threshold`` markers, a local
    least-squares analysis of the neighborhood repeatedly removes the
    edge with the worst residual (and its reverse complement) until all
    residuals are below ``least_square_error_threshold``.

    Sets graph.inconsistent in place; returns the flagged edge count.
    """
    offsets = edge_average_offsets(graph, alignments)
    orid0, orid1 = graph.orid0, graph.orid1

    # ---- Vectorized triangle enumeration (replaces the former
    # O(deg^3) per-vertex Python loops; the reference runs this pass
    # multithreaded, here it is one set of array passes). Triangles
    # (v0 < v1 < v2, v0 on strand 0) are wedges around the middle
    # vertex v1 closed by an edge (v0, v2). ----
    dead0 = graph.crosses_strands | graph.inconsistent
    live = ~dead0
    if is_chimeric is not None:
        live &= ~is_chimeric[orid0 >> 1] & ~is_chimeric[orid1 >> 1]
    eids = np.flatnonzero(live)
    if eids.shape[0] == 0:
        return 0
    p = orid0[eids]  # p < q by construction
    q = orid1[eids]
    n_or = graph.n_oriented_reads

    # CSR of edges by higher endpoint (lower neighbors of each vertex)
    # and by lower endpoint (higher neighbors).
    ord_by_q = np.argsort(q, kind="stable")
    low_e = eids[ord_by_q]  # edge ids grouped by their higher endpoint
    low_cnt = np.bincount(q, minlength=n_or)
    low_off = np.concatenate(([0], np.cumsum(low_cnt)))
    ord_by_p = np.argsort(p, kind="stable")
    high_e = eids[ord_by_p]
    high_cnt = np.bincount(p, minlength=n_or)
    high_off = np.concatenate(([0], np.cumsum(high_cnt)))

    # Wedge expansion around every middle vertex v1.
    n_wedge_v = low_cnt * high_cnt
    total = int(n_wedge_v.sum())
    tris = []
    if total:
        wedge_v1 = np.repeat(np.arange(n_or, dtype=np.int64), n_wedge_v)
        starts = np.concatenate(([0], np.cumsum(n_wedge_v)))
        t = np.arange(total, dtype=np.int64) - starts[wedge_v1]
        i_low = t // high_cnt[wedge_v1]
        i_high = t - i_low * high_cnt[wedge_v1]
        e01 = low_e[low_off[wedge_v1] + i_low]
        e12 = high_e[high_off[wedge_v1] + i_high]
        v0 = orid0[e01]
        v2 = orid1[e12]
        # v0 must be on strand 0 (the loop starts at (read0, 0)).
        sel = (v0 & 1) == 0
        e01, e12, v0, v2 = e01[sel], e12[sel], v0[sel], v2[sel]
        wv1 = wedge_v1[sel]
        # Closing edges (v0, v2): all parallel edges via key ranges.
        keys = p.astype(np.int64) * n_or + q.astype(np.int64)
        kord = np.argsort(keys, kind="stable")
        keys_s = keys[kord]
        e_by_key = eids[kord]
        want = v0 * n_or + v2
        lo_i = np.searchsorted(keys_s, want, side="left")
        hi_i = np.searchsorted(keys_s, want, side="right")
        n_close = hi_i - lo_i
        have = n_close > 0
        if have.any():
            e01, e12, v0, v2, wv1 = (
                e01[have], e12[have], v0[have], v2[have], wv1[have]
            )
            lo_i, n_close = lo_i[have], n_close[have]
            # Expand parallel closing edges.
            rep = np.repeat(np.arange(lo_i.shape[0]), n_close)
            kidx = np.repeat(lo_i, n_close) + (
                np.arange(int(n_close.sum()), dtype=np.int64)
                - np.repeat(
                    np.concatenate(([0], np.cumsum(n_close)))[:-1], n_close
                )
            )
            e20 = e_by_key[kidx]
            e01x, e12x, v0x, v1x, v2x = (
                e01[rep], e12[rep], v0[rep], wv1[rep], v2[rep]
            )
            # Closure error with lowest-first edge offsets:
            # v0->v1 (+), v1->v2 (+), v2->v0 (-).
            err = offsets[e01x] + offsets[e12x] - offsets[e20]
            bad = np.abs(err) >= triangle_error_threshold
            if bad.any():
                # Replay order = the original nested-loop visit order:
                # (v0, pos(e01) in adj[v0], pos(e12) in adj[v1],
                #  pos(e20) in adj[v2]).
                i01 = _pos_in_adj(graph, e01x[bad], v0x[bad])
                i12 = _pos_in_adj(graph, e12x[bad], v1x[bad])
                i20 = _pos_in_adj(graph, e20[bad], v2x[bad])
                order = np.lexsort((i20, i12, i01, v0x[bad]))
                bidx = np.flatnonzero(bad)[order]
                tris = list(
                    zip(
                        v0x[bidx].tolist(), v1x[bidx].tolist(),
                        v2x[bidx].tolist(), e01x[bidx].tolist(),
                        e12x[bidx].tolist(), e20[bidx].tolist(),
                    )
                )

    # ---- Least-squares repair, replayed over the (few) violating
    # triangles in visit order, with live flag re-checks exactly like
    # the sequential loop. ----
    flagged_ids = set()
    # Flag re-checks happen at the same granularity as the sequential
    # loop: e01 once per (v0, e01) group, e12 once per (v0, e01, e12)
    # group, e20 per triangle (flags set mid-group do not retroactively
    # skip the rest of that group).
    cur01 = cur12 = None
    allow01 = allow12 = False
    for v0, v1, v2, e01, e12, e20 in tris:
        if (v0, e01) != cur01:
            cur01 = (v0, e01)
            allow01 = e01 not in flagged_ids
            cur12 = None
        if not allow01:
            continue
        if (v0, e01, e12) != cur12:
            cur12 = (v0, e01, e12)
            allow12 = e12 not in flagged_ids
        if not allow12:
            continue
        if e20 in flagged_ids:
            continue
        dead = graph.crosses_strands | graph.inconsistent
        for fe in flagged_ids:
            dead[fe] = True
        verts, edges = _local_neighborhood(
            graph, (v0, v1, v2), least_square_max_distance,
            is_chimeric, dead,
        )
        edges = [e for e in edges if not dead[e]]
        if not edges:
            continue
        vindex = {v: i for i, v in enumerate(verts)}
        while edges:
            x = _least_square_positions(vindex, edges, graph, offsets)
            worst, worst_res = None, -1.0
            for ei in edges:
                u, w = int(orid0[ei]), int(orid1[ei])
                if u > w:
                    u, w = w, u
                res = abs((x[vindex[w]] - x[vindex[u]]) + offsets[ei])
                if res > worst_res:
                    worst, worst_res = ei, res
            if worst_res < least_square_error_threshold:
                break
            flagged_ids.add(worst)
            flagged_ids.add(worst ^ 1)
            edges = [e for e in edges if e != worst and e != (worst ^ 1)]

    for ei in flagged_ids:
        graph.inconsistent[ei] = True
    return len(flagged_ids)


def _pos_in_adj(graph: ReadGraph, edges: np.ndarray, verts: np.ndarray) -> np.ndarray:
    """Position of each edge within the adjacency list of the given
    endpoint (for replaying the sequential visit order)."""
    # Build (vertex, position) -> edge from the CSR once; invert to
    # edge+endpoint -> position.
    n_inc = graph.adj_edges.shape[0]
    inc_vertex = np.repeat(
        np.arange(graph.n_oriented_reads, dtype=np.int64),
        np.diff(graph.adj_offsets),
    )
    inc_pos = np.arange(n_inc, dtype=np.int64) - graph.adj_offsets[inc_vertex]
    # Each (edge, endpoint) pair appears exactly once.
    key_inc = graph.adj_edges * (2 ** 1) + (
        inc_vertex == graph.orid1[graph.adj_edges]
    ).astype(np.int64)
    pos_of = np.zeros(2 * graph.edge_count, dtype=np.int64)
    pos_of[key_inc] = inc_pos
    want = edges * 2 + (verts == graph.orid1[edges]).astype(np.int64)
    return pos_of[want]


def remove_read_graph_bridges(
    graph: ReadGraph,
    alignments: AlignmentStore,
    n_reads: int,
    max_distance: int = 2,
) -> Tuple[ReadGraph, np.ndarray, int]:
    """Remove read graph bridges (reference: removeReadGraphBridges +
    ReadGraph::findBridges, src/AssemblerReadGraph.cpp /
    src/ReadGraph.cpp): for each read, the neighbors within
    ``max_distance`` edges of (read, 0) are grouped into connected
    components of their induced subgraph; direct edges leading outside
    the largest component are bridges, and their alignments are
    dropped. Returns (new_graph, keep_alignment, n_removed).
    """
    keep = np.zeros(alignments.count, dtype=bool)
    keep[graph.alignment_id] = True
    before = int(keep.sum())

    adj_off, adj_e = graph.adj_offsets, graph.adj_edges
    orid0, orid1 = graph.orid0, graph.orid1

    for read0 in range(n_reads):
        v0 = 2 * read0
        # BFS neighborhood (excluding the start vertex).
        seen = {v0}
        order_found = []
        frontier = [v0]
        for _ in range(max_distance):
            nxt = []
            for u in frontier:
                for ei in adj_e[adj_off[u] : adj_off[u + 1]]:
                    w = int(orid1[ei]) if orid0[ei] == u else int(orid0[ei])
                    if w not in seen:
                        seen.add(w)
                        order_found.append(w)
                        nxt.append(w)
            frontier = nxt
            if not frontier:
                break
        if not order_found:
            continue
        neighbors = sorted(order_found)
        index = {w: i for i, w in enumerate(neighbors)}

        dsu = _DSU(len(neighbors))
        for w1 in neighbors:
            for ei in adj_e[adj_off[w1] : adj_off[w1 + 1]]:
                w2 = int(orid1[ei]) if orid0[ei] == w1 else int(orid0[ei])
                if w2 <= w1:
                    continue
                j = index.get(w2)
                if j is not None:
                    dsu.union(index[w1], j)

        comp_sizes: Dict[int, int] = {}
        for i in range(len(neighbors)):
            r = dsu.find(i)
            comp_sizes[r] = comp_sizes.get(r, 0) + 1
        largest = max(comp_sizes, key=lambda r: (comp_sizes[r], -r))

        # Direct edges of v0 leaving the largest component are bridges.
        for ei in adj_e[adj_off[v0] : adj_off[v0 + 1]]:
            w = int(orid1[ei]) if orid0[ei] == v0 else int(orid0[ei])
            i = index.get(w)
            if i is not None and dsu.find(i) != largest:
                keep[graph.alignment_id[ei]] = False

    removed = before - int(keep.sum())
    return build_read_graph(alignments, n_reads, keep), keep, removed
