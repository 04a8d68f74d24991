"""The global marker graph: vertices merge aligned markers; edges
follow reads between surviving vertices.

Counterpart of the reference marker graph
(reference: src/MarkerGraph.hpp, src/AssemblerMarkerGraph.cpp:38-520
for vertex creation, :2028 for edges, :2279 for transitive reduction,
:2843 for pruning).

Key re-design vs the reference: the lock-free 128-bit-CAS union-find
(reference: src/dset64-gccAtomic.hpp) is replaced by an *iterative
min-label hooking + pointer-jumping* union-find over dense arrays —
each round is a gather/scatter-min over the unite pairs followed by
O(log n) pointer-jumping compressions, the exact shape that shards
over a device mesh with collectives (the reference itself finishes with
the same flattening passes, AssemblerMarkerGraph.cpp:131-151).
Label = minimum marker id in the component, which also makes vertex
numbering deterministic (the reference's numbering depends on thread
interleaving).

A global marker id is ``markers.offsets[orid] + ordinal`` — identical
to the reference's getMarkerId (reference: src/AssemblerMarkers.cpp).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.graph.read_graph import ReadGraph
from shasta_tpu_torch.ops.align import AlignmentStore

INVALID_VERTEX = np.int64(-1)


# ---------------------------------------------------------------------------
# Union-find over dense arrays (min-label hooking + pointer jumping)
# ---------------------------------------------------------------------------


def union_find_labels(n: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Connected-component label (min element id) for each of n items
    under the unions (u[i], v[i]): the native sequential min-root DSU.
    Deterministic regardless of pair order.
    """
    from shasta_tpu_torch import native

    return native.union_find_min_labels_native(n, u, v)


# ---------------------------------------------------------------------------
# Vertex creation
# ---------------------------------------------------------------------------


def _selected_alignment_ranges(
    markers: MarkerStore,
    graph: ReadGraph,
    alignments: AlignmentStore,
    is_chimeric: Optional[np.ndarray] = None,
):
    """(orid0, orid1, lo, hi) of the read-graph alignments that
    contribute unite pairs: direct edges only (even index of each RC
    pair), skipping cross-strand edges, inconsistent-alignment edges,
    and chimeric reads (reference:
    createMarkerGraphVerticesThreadFunction1,
    src/AssemblerMarkerGraph.cpp:540-604)."""
    direct = np.arange(0, graph.edge_count, 2, dtype=np.int64)
    ok = ~graph.crosses_strands[direct] & ~graph.inconsistent[direct]
    aids = graph.alignment_id[direct]
    r0 = alignments.read_id0[aids]
    r1 = alignments.read_id1[aids]
    if is_chimeric is not None:
        ok &= ~is_chimeric[r0] & ~is_chimeric[r1]
    aids = aids[ok]
    orid0 = alignments.read_id0[aids].astype(np.int64) * 2
    orid1 = alignments.read_id1[aids].astype(np.int64) * 2 + np.where(
        alignments.same_strand[aids], 0, 1
    )
    lo = alignments.offsets[aids]
    hi = alignments.offsets[aids + 1]
    return orid0, orid1, lo, hi


def union_find_labels_from_alignments(
    markers: MarkerStore,
    graph: ReadGraph,
    alignments: AlignmentStore,
    is_chimeric: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Min-id component labels computed by STREAMING every selected
    alignment's unite pairs (and their reverse complements) straight
    into the native sequential DSU — labels identical to
    gather_unite_pairs + union_find_labels (equality-tested) without
    the 16-byte-per-pair u/v arrays, the run's largest transient at
    genome scale. The reference's unites stream through its lock-free
    DSU the same way (src/AssemblerMarkerGraph.cpp:590-604)."""
    from shasta_tpu_torch import native

    orid0, orid1, lo, hi = _selected_alignment_ranges(
        markers, graph, alignments, is_chimeric
    )
    if orid0.shape[0] == 0:
        return np.arange(markers.total_count, dtype=np.int64)
    return native.unite_from_alignments_native(
        markers.total_count, markers.offsets, markers.counts(),
        orid0, orid1, lo, hi, alignments.ord0, alignments.ord1,
    )


def gather_unite_pairs(
    markers: MarkerStore,
    graph: ReadGraph,
    alignments: AlignmentStore,
    is_chimeric: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Marker-id unite pairs from the read-graph alignments
    (reference: createMarkerGraphVerticesThreadFunction1,
    src/AssemblerMarkerGraph.cpp:540-604): for each direct read-graph
    edge (the even edge of each RC pair), unite every aligned ordinal
    pair and its reverse complement.
    """
    moff = markers.offsets
    counts = np.diff(moff)

    orid0, orid1, lo, hi = _selected_alignment_ranges(
        markers, graph, alignments, is_chimeric
    )
    if orid0.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # One threaded native pass; each pair lands beside its reverse
    # complement, and every consumer is order-independent.
    from shasta_tpu_torch import native

    return native.expand_unite_pairs_native(
        moff, counts, orid0, orid1, lo, hi, alignments.ord0, alignments.ord1
    )


@dataclass
class MarkerGraph:
    """Vertices + edges of the global marker graph.

    - ``vertex_table``: int64 [total_markers] -> vertex id or -1
      (reference: MarkerGraph::vertexTable)
    - ``vertex_offsets``/``vertex_markers``: CSR vertex -> sorted
      marker ids (reference: MarkerGraph::vertices())
    - ``rc_vertex``: reverse complement vertex of each vertex
    - edges: ``source``, ``target``, ``coverage`` (+ removal flags),
      RC pairing via ``rc_edge``
    - ``interval_*``: CSR edge -> MarkerInterval(orid, ord0, ord1)
    """

    vertex_table: np.ndarray  # int64 [total_markers]
    vertex_offsets: np.ndarray  # int64 [n_vertices+1]
    vertex_markers: np.ndarray  # int64 [sum coverage]
    rc_vertex: np.ndarray  # int64 [n_vertices]

    source: np.ndarray = None  # int64 [n_edges]
    target: np.ndarray = None  # int64 [n_edges]
    coverage: np.ndarray = None  # int32 [n_edges]
    rc_edge: np.ndarray = None  # int64 [n_edges]
    removed_tr: np.ndarray = None  # bool — wasRemovedByTransitiveReduction
    pruned: np.ndarray = None  # bool — wasPruned
    superbubble: np.ndarray = None  # bool — isSuperBubbleEdge
    low_coverage_cross: np.ndarray = None  # bool — isLowCoverageCrossEdge
    removed_split: np.ndarray = None  # bool — wasRemovedWhileSplittingSecondaryEdges
    interval_offsets: np.ndarray = None  # int64 [n_edges+1]
    interval_orid: np.ndarray = None  # int64 [total intervals]
    interval_ord0: np.ndarray = None  # int32
    interval_ord1: np.ndarray = None  # int32
    # Adjacency over alive edges (built on demand).
    _by_source_off: np.ndarray = None
    _by_source: np.ndarray = None
    _by_target_off: np.ndarray = None
    _by_target: np.ndarray = None

    @property
    def vertex_count(self) -> int:
        return self.vertex_offsets.shape[0] - 1

    @property
    def edge_count(self) -> int:
        return 0 if self.source is None else self.source.shape[0]

    def vertex_coverage(self) -> np.ndarray:
        return np.diff(self.vertex_offsets)

    def vertex_marker_ids(self, v: int) -> np.ndarray:
        return self.vertex_markers[self.vertex_offsets[v] : self.vertex_offsets[v + 1]]

    def edge_intervals(self, e: int):
        lo, hi = self.interval_offsets[e], self.interval_offsets[e + 1]
        return (
            self.interval_orid[lo:hi],
            self.interval_ord0[lo:hi],
            self.interval_ord1[lo:hi],
        )

    def alive(self) -> np.ndarray:
        """Edges surviving all removal flags."""
        dead = np.zeros(self.edge_count, dtype=bool)
        for f in (self.removed_tr, self.pruned, self.superbubble,
                  self.low_coverage_cross, self.removed_split):
            if f is not None:
                dead |= f
        return np.logical_not(dead, out=dead)

    def build_adjacency(self) -> None:
        n = self.vertex_count
        e = np.arange(self.edge_count, dtype=np.int64)
        o = np.argsort(self.source, kind="stable")
        self._by_source = e[o]
        self._by_source_off = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(self.source, minlength=n), out=self._by_source_off[1:])
        o = np.argsort(self.target, kind="stable")
        self._by_target = e[o]
        self._by_target_off = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(self.target, minlength=n), out=self._by_target_off[1:])

    def edges_by_source(self, v: int) -> np.ndarray:
        return self._by_source[self._by_source_off[v] : self._by_source_off[v + 1]]

    def edges_by_target(self, v: int) -> np.ndarray:
        return self._by_target[self._by_target_off[v] : self._by_target_off[v + 1]]

    def arrays(self) -> Dict[str, np.ndarray]:
        out = {
            "vertex_table": self.vertex_table,
            "vertex_offsets": self.vertex_offsets,
            "vertex_markers": self.vertex_markers,
            "rc_vertex": self.rc_vertex,
        }
        if self.source is not None:
            out.update(
                source=self.source,
                target=self.target,
                coverage=self.coverage,
                rc_edge=self.rc_edge,
                removed_tr=self.removed_tr,
                pruned=self.pruned,
                superbubble=self.superbubble,
                low_coverage_cross=self.low_coverage_cross,
                interval_offsets=self.interval_offsets,
                interval_orid=self.interval_orid,
                interval_ord0=self.interval_ord0,
                interval_ord1=self.interval_ord1,
            )
            if self.removed_split is not None:
                out["removed_split"] = self.removed_split
        return out

    @classmethod
    def from_arrays(cls, a) -> "MarkerGraph":
        kw = {k: a[k] for k in a if not k.startswith("_")}
        return cls(**kw)


def create_marker_graph_vertices(
    markers: MarkerStore,
    unite_u: np.ndarray,
    unite_v: np.ndarray,
    min_coverage: int = 2,
    max_coverage: int = 100,
    min_coverage_per_strand: int = 0,
    allow_duplicate_markers: bool = False,
    labels: Optional[np.ndarray] = None,
) -> MarkerGraph:
    """Union markers, filter by coverage, flag bad sets, renumber.

    Follows reference createMarkerGraphVertices
    (src/AssemblerMarkerGraph.cpp:38-520): disjoint sets with coverage
    outside [min_coverage, max_coverage] are dropped; sets with more
    than one marker of the same read are bad (ThreadFunction7 at :697),
    as are sets whose per-strand coverage is below
    ``min_coverage_per_strand``. Vertex ids are assigned in increasing
    order of the set's minimum marker id (deterministic).
    """
    total = markers.total_count
    if total == 0:
        return MarkerGraph(
            vertex_table=np.zeros(0, np.int64),
            vertex_offsets=np.zeros(1, np.int64),
            vertex_markers=np.zeros(0, np.int64),
            rc_vertex=np.zeros(0, np.int64),
        )
    # A mesh-sharded union-find may supply precomputed labels (they
    # are verified identical to the host labeling by construction).
    label = (
        labels
        if labels is not None
        else union_find_labels(total, unite_u, unite_v)
    )

    # Coverage per set. Labels are min-member representatives
    # (label[label] == label), so the unique/inverse/counts triple
    # falls out of linear passes — np.unique would sort all markers
    # (the stage's top cost at 10^8+ markers on the 4-core host).
    # Index arrays stay int32 below 2^31 markers: the transient
    # footprint of this stage was the run's largest untracked RSS
    # (memprof r4 ONT-25Mb: +7 GB retained, 17.8 GB peak at 91M
    # markers before the narrowing; the reference packs the same
    # tables into Uint40/Uint24, src/MarkerGraph.hpp:32-37).
    idt = np.int32 if total < 2**31 else np.int64
    is_rep = np.zeros(total, bool)
    is_rep[label] = True
    reps = np.flatnonzero(is_rep)
    rank = np.cumsum(is_rep, dtype=idt)
    rank -= 1  # rep marker id -> dense rank
    inverse = rank[label]
    del rank
    if labels is None:
        del label  # the caller-scope array persists only when passed in
    cov = np.bincount(inverse, minlength=reps.shape[0])
    good = (cov >= min_coverage) & (cov <= max_coverage)

    # Oriented-read id of each marker (one linear expansion of the CSR).
    moff = markers.offsets
    orid_of_marker = np.repeat(
        np.arange(moff.shape[0] - 1, dtype=idt), np.diff(moff)
    )

    # Bad-set detection, vectorized over all markers grouped by set:
    # sort markers by (set, marker id) — marker id order groups same
    # reads adjacently the same way the reference relies on sorted
    # marker ids (src/AssemblerMarkerGraph.cpp:723-733). The grouping
    # key is dense, so one native counting-sort pass replaces the full
    # argsort (the stage's top host cost at 10^8+ markers).
    from shasta_tpu_torch import native as _native

    set_starts = np.zeros(reps.shape[0], np.int64)
    np.cumsum(cov[:-1], out=set_starts[1:])
    if idt is np.int32:
        order = _native.counting_sort_by_key32_native(inverse, set_starts)
    else:
        # The native sort takes int32 keys: 2^31 markers and more sort here.
        order = np.argsort(inverse, kind="stable")
    g = inverse[order]

    same_set = np.empty(total, dtype=bool)
    same_set[0] = False
    np.equal(g[1:], g[:-1], out=same_set[1:])

    if not allow_duplicate_markers:
        r_sorted = orid_of_marker[order] >> 1
        dup = same_set & (r_sorted == np.concatenate(([-1], r_sorted[:-1])))
        del r_sorted
        bad_dup = np.zeros(reps.shape[0], dtype=bool)
        np.logical_or.at(bad_dup, g[dup], True)
        del dup
    else:
        bad_dup = np.zeros(reps.shape[0], dtype=bool)
    del g, same_set

    if min_coverage_per_strand > 0:
        c0 = np.bincount(
            inverse[(orid_of_marker & 1) == 0], minlength=reps.shape[0]
        )
        c1 = cov - c0
        bad_strand = (c0 < min_coverage_per_strand) | (c1 < min_coverage_per_strand)
    else:
        bad_strand = np.zeros(reps.shape[0], dtype=bool)

    keep_set = good & ~bad_dup & ~bad_strand

    # Final numbering: surviving sets in increasing order of their
    # minimum marker id, which equals the representative label.
    # reps is sorted ascending already, so numbering follows.
    kept_reps_idx = np.flatnonzero(keep_set)
    new_id = np.full(reps.shape[0], INVALID_VERTEX, dtype=idt)
    new_id[kept_reps_idx] = np.arange(kept_reps_idx.shape[0], dtype=idt)

    vertex_table = new_id[inverse]
    del inverse

    # CSR vertex -> sorted marker ids: the same skip-negatives native
    # counting sort groups kept markers by vertex id directly from
    # vertex_table (marker order within a vertex stays ascending).
    n_vertices = kept_reps_idx.shape[0]
    n_kept = int(cov[kept_reps_idx].sum())
    vertex_offsets = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(cov[kept_reps_idx], out=vertex_offsets[1:])
    if idt is np.int32:
        vertex_markers = _native.counting_sort_by_key32_native(
            vertex_table, vertex_offsets[:-1], n_out=n_kept
        )
    else:
        # The native sort takes int32 keys: 2^31 markers and more sort here.
        keep_marker = vertex_table >= 0
        vm = np.flatnonzero(keep_marker)
        vt = vertex_table[vm]
        o = np.argsort(vt, kind="stable")  # marker order kept in vertex
        vertex_markers = vm[o].astype(idt)

    # Reverse complement vertex: vertex of the RC of the first marker.
    counts = np.diff(moff)
    first_marker = vertex_markers[vertex_offsets[:-1]] if n_vertices else np.zeros(0, np.int64)
    fm_orid = orid_of_marker[first_marker]
    fm_ord = first_marker - moff[fm_orid]
    rc_marker = moff[fm_orid ^ 1] + (counts[fm_orid] - 1 - fm_ord)
    rc_vertex = vertex_table[rc_marker]

    return MarkerGraph(
        vertex_table=vertex_table,
        vertex_offsets=vertex_offsets,
        vertex_markers=vertex_markers,
        rc_vertex=rc_vertex,
    )


def check_strand_symmetry(mg: MarkerGraph) -> bool:
    """Audit the reference's strand-symmetry invariant
    (reference: Assembler::checkMarkerGraphIsStrandSymmetric,
    src/Assembler.hpp:1542): rc is an involution on vertices, and —
    once edges exist — rc_edge is an involution mapping each edge to
    one with swapped, reverse-complemented endpoints."""
    rc = mg.rc_vertex
    if (rc < 0).any():
        return False
    if not np.array_equal(rc[rc], np.arange(mg.vertex_count, dtype=np.int64)):
        return False
    if mg.rc_edge is None or mg.rc_edge.shape[0] == 0:
        return True
    re = mg.rc_edge
    if (re < 0).any():
        return False
    n_edges = re.shape[0]
    if not np.array_equal(re[re], np.arange(n_edges, dtype=np.int64)):
        return False
    if not np.array_equal(mg.source[re], rc[mg.target]):
        return False
    return bool(np.array_equal(mg.target[re], rc[mg.source]))


def check_marker_graph_vertices(mg: MarkerGraph) -> bool:
    """Audit vertexTable <-> vertices consistency (reference:
    Assembler::checkMarkerGraphVertices, src/Assembler.hpp:1275):
    every marker listed by a vertex maps back to that vertex, and
    every marker mapped to a vertex appears in its marker list."""
    n_v = mg.vertex_offsets.shape[0] - 1
    v_of_listed = np.repeat(
        np.arange(n_v, dtype=np.int64), np.diff(mg.vertex_offsets)
    )
    if not np.array_equal(mg.vertex_table[mg.vertex_markers], v_of_listed):
        return False
    # Marker counts per vertex from the table must equal the CSR sizes.
    mapped = mg.vertex_table >= 0
    counts = np.bincount(mg.vertex_table[mapped], minlength=n_v)
    return bool(np.array_equal(counts, np.diff(mg.vertex_offsets)))


def audit_strand_symmetry(mg: MarkerGraph, where: str) -> None:
    """In-pipeline strand-symmetry audit, run as a first-class stage
    like the reference's SHASTA_ASSERT-backed check (reference:
    checkMarkerGraphIsStrandSymmetric run from srcMain/main.cpp)."""
    if not check_strand_symmetry(mg):
        raise RuntimeError(
            f"Marker graph strand symmetry violated after {where}; "
            "this indicates a bug in vertex/edge creation."
        )


# ---------------------------------------------------------------------------
# Edge creation (mode 0)
# ---------------------------------------------------------------------------


def create_marker_graph_edges(markers: MarkerStore, mg: MarkerGraph) -> None:
    """Per oriented read, consecutive markers with surviving vertices
    generate a MarkerInterval; identical (source, target) intervals
    merge into one edge (reference: createMarkerGraphEdges,
    src/AssemblerMarkerGraph.cpp:2028-2180). Fills mg in place."""
    moff = markers.offsets
    total = markers.total_count
    n_or = markers.oriented_read_count

    vt = mg.vertex_table
    idt = np.int32 if total < 2**31 else np.int64
    valid = np.flatnonzero(vt >= 0).astype(idt)  # markers w/ vertices
    if valid.shape[0] == 0:
        _set_empty_edges(mg)
        return
    orid_of_marker = np.repeat(
        np.arange(n_or, dtype=idt), np.diff(moff)
    )
    orid_of_valid = orid_of_marker[valid]
    del orid_of_marker

    # Consecutive valid markers within the same oriented read.
    same = orid_of_valid[1:] == orid_of_valid[:-1]
    i0 = valid[:-1][same]
    i1 = valid[1:][same]
    orid = orid_of_valid[:-1][same]
    del valid, orid_of_valid, same
    src = vt[i0]
    tgt = vt[i1]
    # Ordinals fit uint16 below 65,536 markers/read (reference packs
    # them into Uint24, src/Marker.hpp:42-66); these per-interval
    # arrays persist for the whole run.
    odt = (
        np.uint16
        if int(np.diff(moff).max(initial=0)) < 65536
        else np.int32
    )
    ord0 = (i0 - moff[orid]).astype(odt)
    ord1 = (i1 - moff[orid]).astype(odt)
    del i0, i1

    # Group by (source, target); intervals sorted by (orid, ord0)
    # within the edge, edges sorted by (source, target) — matching the
    # reference's per-vertex sorted-children order. The intervals are
    # generated in flat marker order, i.e. already sorted by
    # (orid, ord0), so two STABLE counting sorts (by tgt, then src)
    # produce the full (src, tgt, orid, ord0) order — replacing a
    # 4-key int64 lexsort over 10^8 intervals that dominated this
    # stage's 25.2 GB RSS peak at SCALE=50 (memprof r4; CLAUDE.md:
    # prefer single-key counting passes on this 4-core host).
    from shasta_tpu_torch import native as _native

    if idt is np.int32 and mg.vertex_count < 2**31:
        starts_t = np.zeros(mg.vertex_count, np.int64)
        np.cumsum(
            np.bincount(tgt, minlength=mg.vertex_count)[:-1],
            out=starts_t[1:],
        )
        order1 = _native.counting_sort_by_key32_native(tgt, starts_t)
        starts_s = np.zeros(mg.vertex_count, np.int64)
        np.cumsum(
            np.bincount(src, minlength=mg.vertex_count)[:-1],
            out=starts_s[1:],
        )
        order = order1[
            _native.counting_sort_by_key32_native(src[order1], starts_s)
        ]
        del order1
    else:
        # The native sort takes int32 keys: 2^31 markers and more sort here.
        order = np.lexsort((ord0, orid, tgt, src))
    src = src[order]
    tgt = tgt[order]
    orid = orid[order].astype(
        np.int32 if n_or < 2**31 else np.int64, copy=False
    )
    ord0 = ord0[order]
    ord1 = ord1[order]
    del order

    new_edge = np.empty(src.shape[0], dtype=bool)
    new_edge[0] = True
    new_edge[1:] = (src[1:] != src[:-1]) | (tgt[1:] != tgt[:-1])
    edge_id_of_interval = np.cumsum(new_edge) - 1
    n_edges = int(edge_id_of_interval[-1]) + 1

    e_src = src[new_edge]
    e_tgt = tgt[new_edge]
    e_cov = np.bincount(edge_id_of_interval).astype(np.int32)
    interval_offsets = np.zeros(n_edges + 1, dtype=np.int64)
    np.cumsum(e_cov, out=interval_offsets[1:])

    # Reverse complement edge: (s, t) -> (rc[t], rc[s]).
    rc_s = mg.rc_vertex[e_tgt]
    rc_t = mg.rc_vertex[e_src]
    # Lookup via the sorted (source, target) key list.
    key = e_src * np.int64(mg.vertex_count) + e_tgt
    rc_key = rc_s * np.int64(mg.vertex_count) + rc_t
    pos = np.searchsorted(key, rc_key)
    pos = np.clip(pos, 0, n_edges - 1)
    found = key[pos] == rc_key
    rc_edge = np.where(found, pos, -1).astype(
        np.int32 if n_edges < 2**31 else np.int64
    )

    mg.source = e_src
    mg.target = e_tgt
    mg.coverage = e_cov
    mg.rc_edge = rc_edge
    mg.removed_tr = np.zeros(n_edges, dtype=bool)
    mg.pruned = np.zeros(n_edges, dtype=bool)
    mg.superbubble = np.zeros(n_edges, dtype=bool)
    mg.low_coverage_cross = np.zeros(n_edges, dtype=bool)
    mg.interval_offsets = interval_offsets
    mg.interval_orid = orid
    mg.interval_ord0 = ord0
    mg.interval_ord1 = ord1
    mg.build_adjacency()


def _set_empty_edges(mg: MarkerGraph) -> None:
    mg.source = np.zeros(0, np.int64)
    mg.target = np.zeros(0, np.int64)
    mg.coverage = np.zeros(0, np.int32)
    mg.rc_edge = np.zeros(0, np.int64)
    mg.removed_tr = np.zeros(0, bool)
    mg.pruned = np.zeros(0, bool)
    mg.superbubble = np.zeros(0, bool)
    mg.low_coverage_cross = np.zeros(0, bool)
    mg.interval_offsets = np.zeros(1, np.int64)
    mg.interval_orid = np.zeros(0, np.int64)
    mg.interval_ord0 = np.zeros(0, np.int32)
    mg.interval_ord1 = np.zeros(0, np.int32)
    mg.build_adjacency()


# ---------------------------------------------------------------------------
# Transitive reduction + prune
# ---------------------------------------------------------------------------


def transitive_reduction(
    mg: MarkerGraph,
    low_coverage_threshold: int = 1,
    high_coverage_threshold: int = 256,
    max_distance: int = 30,
    edge_marker_skip_threshold: int = 100,
) -> None:
    """Flag weak edges (reference: Assembler::transitiveReduction,
    src/AssemblerMarkerGraph.cpp:2279-2500):

    1. edges with coverage <= low_coverage_threshold;
    2. coverage-1 edges whose single marker skip exceeds
       edge_marker_skip_threshold;
    3. remaining edges with coverage < high_coverage_threshold, in
       increasing coverage order: removed if the target is reachable
       from the source within max_distance without the edge, using
       only strong edges.

    Strand-symmetric: the RC edge of every removed edge is removed too.
    """
    n_edges = mg.edge_count
    if n_edges == 0:
        return
    removed = mg.removed_tr
    removed[:] = False
    cov = mg.coverage

    # 1. Low coverage.
    low = cov <= low_coverage_threshold
    removed |= low
    removed |= low[mg.rc_edge.clip(0)] & (mg.rc_edge >= 0)

    # 2. Coverage-1 long-skip edges.
    c1 = np.flatnonzero(cov == 1)
    if c1.shape[0]:
        skips = (
            mg.interval_ord1[mg.interval_offsets[c1]]
            - mg.interval_ord0[mg.interval_offsets[c1]]
        )
        long_skip = c1[skips > edge_marker_skip_threshold]
        removed[long_skip] = True
        rc = mg.rc_edge[long_skip]
        removed[rc[rc >= 0]] = True

    # 3. BFS per edge in increasing coverage order (process each RC
    # pair once, from the lower edge id).
    mg.build_adjacency()
    candidates = np.flatnonzero(
        (cov > low_coverage_threshold)
        & (cov < high_coverage_threshold)
        & (mg.rc_edge >= np.arange(n_edges))
    )
    order = np.argsort(cov[candidates], kind="stable")
    candidates = candidates[order]

    from shasta_tpu_torch import native

    native.transitive_reduction_bfs_native(mg, candidates, max_distance)


def reverse_transitive_reduction(
    mg: MarkerGraph,
    low_coverage_threshold: int = 1,
    high_coverage_threshold: int = 256,
    max_distance: int = 5,
) -> int:
    """Flag weak edges in the reverse direction (reference:
    Assembler::reverseTransitiveReduction,
    src/AssemblerMarkerGraph.cpp:2517): for each not-yet-removed edge
    with low < coverage < high, in increasing coverage order, do a
    forward BFS from the edge's TARGET; if its SOURCE is reachable
    within max_distance over strong edges the edge closes a short
    cycle and is flagged (with its reverse complement). Returns the
    number of edges flagged."""
    n_edges = mg.edge_count
    if n_edges == 0:
        return 0
    removed = mg.removed_tr
    cov = mg.coverage
    mg.build_adjacency()
    by_source_off = mg._by_source_off
    by_source = mg._by_source
    targets = mg.target
    candidates = np.flatnonzero(
        (cov > low_coverage_threshold)
        & (cov < high_coverage_threshold)
        & (mg.rc_edge >= np.arange(n_edges))
    )
    order = np.argsort(cov[candidates], kind="stable")
    candidates = candidates[order]

    dist = np.full(mg.vertex_count, -1, dtype=np.int64)
    n_removed = 0
    for e in candidates:
        if removed[e]:
            continue
        u0 = targets[e]
        u1 = mg.source[e]
        q = deque([u0])
        dist[u0] = 0
        seen = [u0]
        found = False
        while q and not found:
            v0 = q.popleft()
            d1 = dist[v0] + 1
            for ei in by_source[by_source_off[v0] : by_source_off[v0 + 1]]:
                if ei == e or removed[ei]:
                    continue
                v1 = targets[ei]
                if dist[v1] >= 0:
                    continue
                if v1 == u1:
                    found = True
                    break
                dist[v1] = d1
                seen.append(v1)
                if d1 < max_distance:
                    q.append(v1)
        if found:
            removed[e] = True
            rc = mg.rc_edge[e]
            if rc >= 0 and not removed[rc]:
                removed[rc] = True
                n_removed += 1
            n_removed += 1
        for v in seen:
            dist[v] = -1
    return n_removed


def prune(mg: MarkerGraph, iteration_count: int = 6) -> None:
    """Iteratively prune leaf edges (reference:
    pruneMarkerGraphStrongSubgraph, src/AssemblerMarkerGraph.cpp:2843):
    at each iteration flag edges whose target is a forward leaf
    (out-degree 0) or whose source is a backward leaf (in-degree 0)
    of the current strong subgraph."""
    n_edges = mg.edge_count
    if n_edges == 0:
        return
    n_v = mg.vertex_count
    mg.pruned[:] = False
    for _ in range(iteration_count):
        alive = ~mg.removed_tr & ~mg.pruned
        out_deg = np.bincount(mg.source[alive], minlength=n_v)
        in_deg = np.bincount(mg.target[alive], minlength=n_v)
        to_prune = alive & (
            (out_deg[mg.target] == 0) | (in_deg[mg.source] == 0)
        )
        if not to_prune.any():
            break
        mg.pruned |= to_prune


# ---------------------------------------------------------------------------
# Duplicate-marker cleanup
# ---------------------------------------------------------------------------


def _rebuild_from_vertex_table(markers: MarkerStore, table: np.ndarray) -> MarkerGraph:
    """Renumber a raw vertex table (arbitrary non-negative ids, -1 for
    no vertex) contiguously by each vertex's minimum marker id, then
    rebuild the CSR marker lists and reverse-complement pairing
    (reference: MarkerGraph::renumberVertexTable +
    createVerticesFromVertexTable + findMarkerGraphReverseComplementVertices)."""
    moff = markers.offsets
    total = table.shape[0]
    valid = table >= 0
    vm = np.flatnonzero(valid)
    ids = table[vm]
    uniq, first_idx = np.unique(ids, return_index=True)
    # Renumber in order of first (minimum) marker id.
    order = np.argsort(first_idx, kind="stable")
    new_of_uniq = np.empty(uniq.shape[0], dtype=np.int64)
    new_of_uniq[order] = np.arange(uniq.shape[0], dtype=np.int64)
    vertex_table = np.full(total, INVALID_VERTEX, dtype=np.int64)
    vertex_table[vm] = new_of_uniq[np.searchsorted(uniq, ids)]

    n_vertices = uniq.shape[0]
    vt = vertex_table[vm]
    o = np.argsort(vt, kind="stable")
    vertex_markers = vm[o]
    vertex_offsets = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(np.bincount(vt, minlength=n_vertices), out=vertex_offsets[1:])

    counts = np.diff(moff)
    orid_of_marker = (
        np.searchsorted(moff, np.arange(total, dtype=np.int64), side="right") - 1
    )
    first_marker = (
        vertex_markers[vertex_offsets[:-1]] if n_vertices else np.zeros(0, np.int64)
    )
    fm_orid = orid_of_marker[first_marker]
    fm_ord = first_marker - moff[fm_orid]
    rc_marker = moff[fm_orid ^ 1] + (counts[fm_orid] - 1 - fm_ord)
    rc_vertex = vertex_table[rc_marker]
    return MarkerGraph(
        vertex_table=vertex_table,
        vertex_offsets=vertex_offsets,
        vertex_markers=vertex_markers,
        rc_vertex=rc_vertex,
    )


def cleanup_duplicate_markers(
    markers: MarkerStore,
    mg: MarkerGraph,
    unite_u: np.ndarray,
    unite_v: np.ndarray,
    min_coverage: int,
    min_coverage_per_strand: int = 0,
    pattern1_threshold: float = 0.5,
    pattern1_create_new_vertices: bool = False,
    pattern2_create_new_vertices: bool = False,
) -> MarkerGraph:
    """Split or trim "bad" vertices (vertices with more than one marker
    on the same oriented read), used with
    --MarkerGraph.allowDuplicateMarkers --MarkerGraph.cleanupDuplicateMarkers
    (reference: Assembler::cleanupDuplicateMarkers,
    src/AssemblerMarkerGraphCleanupDuplicateMarkers.cpp:72-550).

    Pattern 1 (duplicate ratio < pattern1_threshold): remove the
    duplicate markers; drop the whole vertex if the remainder fails the
    coverage criteria. Pattern 2: connected components of the vertex's
    marker connectivity graph restricted to edges between duplicate
    markers; a component with no internal duplicates and sufficient
    coverage becomes a new vertex (with its reverse complement);
    anything else is dropped (or becomes singleton vertices when the
    create flags allow). Returns a rebuilt MarkerGraph (vertices only).
    """
    moff = markers.offsets
    counts = np.diff(moff)
    total = markers.total_count
    orid_of_marker = (
        np.searchsorted(moff, np.arange(total, dtype=np.int64), side="right") - 1
    )

    def rc_of(m):
        orid = orid_of_marker[m]
        return moff[orid ^ 1] + (counts[orid] - 1 - (m - moff[orid]))

    # Find bad vertices: duplicate oriented reads among a vertex's
    # markers (marker ids are sorted within a vertex, so equal orids
    # are adjacent).
    vm = mg.vertex_markers
    voff = mg.vertex_offsets
    n_vertices = mg.vertex_count
    orid_of_vm = orid_of_marker[vm]
    dup_pos = np.zeros(vm.shape[0], dtype=bool)
    if vm.shape[0] > 1:
        same_vertex = np.zeros(vm.shape[0], dtype=bool)
        vid_of_pos = (
            np.searchsorted(voff, np.arange(vm.shape[0], dtype=np.int64), side="right")
            - 1
        )
        same_vertex[1:] = vid_of_pos[1:] == vid_of_pos[:-1]
        adj_dup = same_vertex & np.concatenate(
            ([False], orid_of_vm[1:] == orid_of_vm[:-1])
        )
        dup_pos |= adj_dup
        dup_pos[:-1] |= adj_dup[1:]
    bad_vertex = np.zeros(n_vertices, dtype=bool)
    if vm.shape[0]:
        np.logical_or.at(bad_vertex, vid_of_pos[dup_pos], True)
    if not bad_vertex.any():
        return mg

    # Marker connectivity edges per bad vertex: unite pairs whose
    # endpoints live in the same bad vertex.
    table = mg.vertex_table.copy()
    pair_vid = table[unite_u]
    in_bad = (pair_vid >= 0) & bad_vertex[np.maximum(pair_vid, 0)]
    in_bad &= table[unite_v] == pair_vid
    bu, bv, bvid = unite_u[in_bad], unite_v[in_bad], pair_vid[in_bad]
    edge_order = np.argsort(bvid, kind="stable")
    bu, bv, bvid = bu[edge_order], bv[edge_order], bvid[edge_order]
    edge_starts = np.searchsorted(bvid, np.arange(n_vertices + 1))

    create_singletons1 = (
        pattern1_create_new_vertices and min_coverage <= 1
        and min_coverage_per_strand == 0
    )
    create_singletons2 = (
        pattern2_create_new_vertices and min_coverage <= 1
        and min_coverage_per_strand == 0
    )
    next_id = [np.int64(n_vertices)]

    def fresh():
        v = next_id[0]
        next_id[0] += 1
        return v

    def assign(m, value):
        table[m] = value

    stats = {"bad": 0, "pattern1": 0, "pattern2": 0}

    for vid in np.flatnonzero(bad_vertex):
        rc_vid = mg.rc_vertex[vid]
        if rc_vid < vid:
            continue  # handled together with its reverse complement
        stats["bad"] += 1 if rc_vid == vid else 2

        mk = vm[voff[vid] : voff[vid + 1]]
        orids = orid_of_marker[mk]
        strands = orids & 1
        is_dup = np.zeros(mk.shape[0], dtype=bool)
        adj = orids[1:] == orids[:-1]
        is_dup[1:] |= adj
        is_dup[:-1] |= adj
        dup_count = int(is_dup.sum())
        marker_count = mk.shape[0]

        if dup_count / marker_count < pattern1_threshold:
            # Pattern 1: drop (or singleton) the duplicates.
            stats["pattern1"] += 1 if rc_vid == vid else 2
            for m in mk[is_dup]:
                rm = rc_of(m)
                if create_singletons1:
                    assign(m, fresh())
                    if rm != m:
                        assign(rm, fresh())
                else:
                    assign(m, INVALID_VERTEX)
                    assign(rm, INVALID_VERTEX)
            c0 = int((strands[~is_dup] == 0).sum())
            c1 = int((strands[~is_dup] == 1).sum())
            if not (
                c0 >= min_coverage_per_strand
                and c1 >= min_coverage_per_strand
                and c0 + c1 >= min_coverage
            ):
                for m in mk[~is_dup]:
                    rm = rc_of(m)
                    assign(m, INVALID_VERTEX)
                    assign(rm, INVALID_VERTEX)
            continue

        # Pattern 2: components over duplicate-duplicate connectivity.
        stats["pattern2"] += 1 if rc_vid == vid else 2
        local = {int(m): i for i, m in enumerate(mk)}
        dsu = _P2DSU(marker_count)
        lo, hi = edge_starts[vid], edge_starts[vid + 1]
        dup_set = set(int(m) for m in mk[is_dup])
        for u, v in zip(bu[lo:hi], bv[lo:hi]):
            if int(u) in dup_set and int(v) in dup_set:
                dsu.union(local[int(u)], local[int(v)])
        comp_of = np.array([dsu.find(i) for i in range(marker_count)])
        for root in np.unique(comp_of):
            idx = np.flatnonzero(comp_of == root)
            comp_orids = orids[idx]
            has_dup = np.unique(comp_orids).shape[0] < comp_orids.shape[0]
            c0 = int((comp_orids & 1 == 0).sum())
            c1 = idx.shape[0] - c0
            if (
                not has_dup
                and c0 >= min_coverage_per_strand
                and c1 >= min_coverage_per_strand
                and c0 + c1 >= min_coverage
            ):
                nv = fresh()
                nv_rc = fresh()
                for m in mk[idx]:
                    rm = rc_of(m)
                    assign(m, nv)
                    if rm != m:
                        assign(rm, nv_rc)
            elif create_singletons2:
                for m in mk[idx]:
                    rm = rc_of(m)
                    assign(m, fresh())
                    if rm != m:
                        assign(rm, fresh())
            else:
                for m in mk[idx]:
                    rm = rc_of(m)
                    assign(m, INVALID_VERTEX)
                    assign(rm, INVALID_VERTEX)

    out = _rebuild_from_vertex_table(markers, table)
    out.cleanup_stats = stats
    return out


class _P2DSU:
    __slots__ = ("parent",)

    def __init__(self, n):
        self.parent = list(range(n))

    def find(self, x):
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)
