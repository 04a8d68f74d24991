"""Mode 3 PathGraph: journey-snippet clustering and detangling.

Counterpart of the reference's experimental mode3::PathGraph
(reference: src/mode3-PathGraph.cpp, driven by
Assembler::createMode3PathGraph at src/AssemblerMode3.cpp:60). A
PathGraph vertex represents a path in the mode-3 assembly graph
(initially one segment); edges connect vertices visited consecutively
by enough oriented reads. The graph is partitioned into local
subgraphs, and each subgraph is detangled by clustering the *journey
snippets* (maximal runs of consecutive path-graph journey positions)
of its oriented reads: snippets with approximately-subset vertex sets
are linked into a SnippetGraph, strongly connected components are
condensed, and each maximal vertex's exclusive descendants form a
cluster whose induced linear chains become the new, longer path
vertices of the next iteration (reference:
src/mode3-PathGraph.cpp:655-1180 detangleSubgraphTemplate).

The reference constructor includes an interactive stdin loop for
debugging single subgraphs; this implementation runs the
non-interactive detangle iteration directly. Host-side graph passes
mirror the reference's sequential implementation (the graphs are small
condensed structures); the snippet subset tests are vectorized as one
integer matmul per subgraph instead of per-pair bitset sweeps.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

NO_SUBGRAPH = np.int64(-1)


@dataclass
class PathGraphVertex:
    """A path in the mode-3 assembly graph plus the journey intervals
    of the oriented reads that follow it (reference:
    src/mode3-PathGraph.hpp PathGraphVertex)."""

    path: List[int]
    # (orid, first, last): positions in the oriented read's
    # assembly-graph journey covered by this vertex.
    intervals: List[Tuple[int, int, int]] = field(default_factory=list)
    # Position of each interval in the oriented read's PATH-GRAPH
    # journey, filled by compute_journeys (parallel to intervals).
    journey_positions: List[int] = field(default_factory=list)


def _tarjan_scc(n: int, adj: Sequence[Sequence[int]]) -> np.ndarray:
    """Iterative Tarjan strongly-connected components; returns a
    component id per vertex (reference uses boost::strong_components)."""
    index = np.full(n, -1, np.int64)
    low = np.zeros(n, np.int64)
    on_stack = np.zeros(n, bool)
    comp = np.full(n, -1, np.int64)
    stack: List[int] = []
    counter = 0
    n_comp = 0
    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            advanced = False
            while pi < len(adj[v]):
                w = adj[v][pi]
                pi += 1
                if index[w] == -1:
                    work[-1] = (v, pi)
                    work.append((w, 0))
                    advanced = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp[w] = n_comp
                    if w == v:
                        break
                n_comp += 1
    return comp


def _transitive_reduction_dag(n: int, edges: set) -> set:
    """Remove edges implied by longer paths (small host DAGs only)."""
    adj: List[List[int]] = [[] for _ in range(n)]
    for u, v in edges:
        adj[u].append(v)
    keep = set()
    for u, v in edges:
        # BFS from u avoiding the direct edge; if v is reachable, drop.
        seen = {u}
        q = [u]
        found = False
        while q and not found:
            x = q.pop()
            for y in adj[x]:
                if x == u and y == v:
                    continue
                if y == v:
                    found = True
                    break
                if y not in seen:
                    seen.add(y)
                    q.append(y)
        if not found:
            keep.add((u, v))
    return keep


def _linear_vertex_chains(
    n: int, edges: Iterable[Tuple[int, int]]
) -> List[List[int]]:
    """Maximal linear chains of vertices (reference:
    src/findLinearChains.hpp findLinearVertexChains)."""
    out_adj: Dict[int, List[int]] = {}
    in_adj: Dict[int, List[int]] = {}
    for u, v in edges:
        out_adj.setdefault(u, []).append(v)
        in_adj.setdefault(v, []).append(u)
    found = np.zeros(n, bool)
    chains: List[List[int]] = []
    for start in range(n):
        if found[start]:
            continue
        chain = [start]
        found[start] = True
        circular = False
        v = start
        while True:
            outs = out_adj.get(v, [])
            if len(outs) != 1:
                break
            v = outs[0]
            if v == start:
                circular = True
                break
            if len(in_adj.get(v, [])) != 1:
                break
            chain.append(v)
            found[v] = True
        if not circular:
            v = start
            while True:
                ins = in_adj.get(v, [])
                if len(ins) != 1:
                    break
                v = ins[0]
                if len(out_adj.get(v, [])) != 1:
                    break
                chain.insert(0, v)
                found[v] = True
        chains.append(chain)
    return chains


class PathGraph:
    """The mode-3 path graph over one set of journey data.

    ``n_segments`` + the assembly-graph journey CSR fully determine the
    initial graph; :func:`create_mode3_path_graph` adapts a
    :class:`~shasta_tpu_torch.graph.mode3.Mode3Graph`.
    """

    def __init__(
        self,
        n_segments: int,
        journey_offsets: np.ndarray,
        journey_segments: np.ndarray,
        min_coverage: int = 3,
        partition_max_distance: int = 10,
        min_subgraph_size: int = 8,
        # Detangle knobs (reference hardwired constants,
        # src/mode3-PathGraph.cpp:655-664).
        fraction_threshold: float = 0.05,
        min_vertex_coverage: int = 6,
        min_cluster_coverage: int = 6,
    ):
        self.journey_offsets = np.asarray(journey_offsets, np.int64)
        self.journey_segments = np.asarray(journey_segments, np.int64)
        self.n_or = self.journey_offsets.shape[0] - 1
        self.min_coverage = int(min_coverage)
        self.partition_max_distance = int(partition_max_distance)
        self.min_subgraph_size = int(min_subgraph_size)
        self.fraction_threshold = float(fraction_threshold)
        self.min_vertex_coverage = int(min_vertex_coverage)
        self.min_cluster_coverage = int(min_cluster_coverage)

        # Initial vertices: one per segment, intervals = the journey
        # entries that visit it (reference: createVertices,
        # src/mode3-PathGraph.cpp:97-128).
        counts = np.diff(self.journey_offsets)
        orid_of = np.repeat(np.arange(self.n_or, dtype=np.int64), counts)
        pos_of = (
            np.arange(self.journey_segments.shape[0], dtype=np.int64)
            - np.repeat(self.journey_offsets[:-1], counts)
        )
        self.vertices: List[PathGraphVertex] = [
            PathGraphVertex(path=[s]) for s in range(n_segments)
        ]
        for seg, orid, pos in zip(self.journey_segments, orid_of, pos_of):
            self.vertices[int(seg)].intervals.append(
                (int(orid), int(pos), int(pos))
            )
        self._rebuild()

    # ---- graph (re)construction ----

    def _rebuild(self) -> None:
        self.create_edges()
        self.compute_journeys()
        self.subgraph_of = np.full(len(self.vertices), NO_SUBGRAPH)
        self.subgraphs: List[List[int]] = []

    def _interval_table(self):
        """(orid, first, last, vertex) rows for every interval."""
        rows = []
        for vi, v in enumerate(self.vertices):
            for orid, first, last in v.intervals:
                rows.append((orid, first, last, vi))
        if not rows:
            return np.zeros((0, 4), np.int64)
        table = np.asarray(rows, np.int64)
        order = np.lexsort((table[:, 1], table[:, 0]))
        return table[order]

    def create_edges(self) -> None:
        """Edges between vertices visited consecutively by an oriented
        read, with coverage >= min_coverage (reference: createEdges,
        src/mode3-PathGraph.cpp:148-205)."""
        table = self._interval_table()
        edge_cov: Dict[Tuple[int, int], int] = {}
        same = (table[1:, 0] == table[:-1, 0]) & (
            table[1:, 3] != table[:-1, 3]
        )
        for i in np.flatnonzero(same):
            key = (int(table[i, 3]), int(table[i + 1, 3]))
            edge_cov[key] = edge_cov.get(key, 0) + 1
        self.edges = {
            k: c for k, c in edge_cov.items() if c >= self.min_coverage
        }
        n = len(self.vertices)
        self.out_adj: List[List[int]] = [[] for _ in range(n)]
        self.in_adj: List[List[int]] = [[] for _ in range(n)]
        for (u, v), _c in sorted(self.edges.items()):
            self.out_adj[u].append(v)
            self.in_adj[v].append(u)

    def compute_journeys(self) -> None:
        """Per-oriented-read vertex journeys; also stores each
        interval's position in that journey (reference:
        computeJourneys, src/mode3-PathGraph.cpp:207-258)."""
        table = self._interval_table()
        # Sanity check, like the reference: intervals of one oriented
        # read must be disjoint and ordered.
        same = table[1:, 0] == table[:-1, 0]
        assert (table[1:, 1][same] > table[:-1, 2][same]).all(), (
            "overlapping journey intervals"
        )
        self.journeys: List[List[int]] = [[] for _ in range(self.n_or)]
        for v in self.vertices:
            v.journey_positions = [0] * len(v.intervals)
        pos_in_vertex: Dict[Tuple[int, int, int], int] = {}
        for vi, v in enumerate(self.vertices):
            for k, (orid, first, last) in enumerate(v.intervals):
                pos_in_vertex[(orid, first, vi)] = k
        counts = np.zeros(self.n_or, np.int64)
        for orid, first, _last, vi in table:
            p = int(counts[orid])
            self.journeys[int(orid)].append(int(vi))
            k = pos_in_vertex[(int(orid), int(first), int(vi))]
            self.vertices[int(vi)].journey_positions[k] = p
            counts[orid] += 1

    # ---- partition ----

    def partition(self) -> None:
        """Partition into local subgraphs by bounded BFS from source
        vertices, then merge small subgraphs into their smallest
        neighbours (reference: partition/partitionIteration,
        src/mode3-PathGraph.cpp:286-485)."""
        n = len(self.vertices)
        self.subgraph_of = np.full(n, NO_SUBGRAPH)
        stack = [v for v in range(n) if not self.in_adj[v]]
        next_id = 0
        while stack:
            v = stack.pop()
            if self.subgraph_of[v] == NO_SUBGRAPH:
                boundary = self._partition_iteration(v, next_id)
                next_id += 1
                stack.extend(boundary)
        for v in range(n):
            if self.subgraph_of[v] == NO_SUBGRAPH:
                self._partition_iteration(v, next_id)
                next_id += 1

        # Merge small subgraphs with their smallest adjacent subgraph.
        while True:
            self._gather_subgraphs()
            small = {
                sid
                for sid, sg in enumerate(self.subgraphs)
                if 0 < len(sg) < self.min_subgraph_size
            }
            changed = False
            for sid0 in sorted(small):
                sg0 = self.subgraphs[sid0]
                adjacent = []
                for v0 in sg0:
                    for v1 in self.out_adj[v0] + self.in_adj[v0]:
                        sid1 = int(self.subgraph_of[v1])
                        if sid1 != sid0:
                            adjacent.append((len(self.subgraphs[sid1]), sid1))
                if not adjacent:
                    continue
                adjacent.sort()
                sid1 = adjacent[0][1]
                small.discard(sid1)
                for v0 in sg0:
                    self.subgraph_of[v0] = sid1
                changed = True
            if not changed:
                break
        self._gather_subgraphs()

    def _partition_iteration(self, start: int, sid: int) -> List[int]:
        boundary: List[int] = []
        self.subgraph_of[start] = sid
        dist = {start: 0}
        q = [start]
        while q:
            v0 = q.pop(0)
            d1 = dist[v0] + 1
            for v1 in self.out_adj[v0]:
                if self.subgraph_of[v1] != NO_SUBGRAPH:
                    continue
                if d1 <= self.partition_max_distance:
                    self.subgraph_of[v1] = sid
                    dist[v1] = d1
                    q.append(v1)
                else:
                    boundary.append(v1)
        return boundary

    def _gather_subgraphs(self) -> None:
        n_sub = int(self.subgraph_of.max()) + 1 if len(self.vertices) else 0
        self.subgraphs = [[] for _ in range(n_sub)]
        for v in range(len(self.vertices)):
            self.subgraphs[int(self.subgraph_of[v])].append(v)

    # ---- detangle ----

    def detangle_subgraph(self, subgraph_id: int) -> List[PathGraphVertex]:
        """Cluster the journey snippets of one subgraph and emit a new
        path vertex per linear chain of each kept cluster (reference:
        detangleSubgraphTemplate, src/mode3-PathGraph.cpp:655-1180)."""
        subgraph = sorted(self.subgraphs[subgraph_id])
        v_index = {v: i for i, v in enumerate(subgraph)}
        nv = len(subgraph)

        # Triplets (orid, path-graph journey position, vertex).
        triplets: List[Tuple[int, int, int]] = []
        for v in subgraph:
            vert = self.vertices[v]
            for (orid, _f, _l), pos in zip(
                vert.intervals, vert.journey_positions
            ):
                triplets.append((orid, pos, v))
        triplets.sort()

        # Journey snippets: streaks of consecutive positions.
        snippets: List[Tuple[int, int, List[int]]] = []  # (orid, first, vs)
        i = 0
        while i < len(triplets):
            orid = triplets[i][0]
            j = i + 1
            while (
                j < len(triplets)
                and triplets[j][0] == orid
                and triplets[j][1] == triplets[j - 1][1] + 1
            ):
                j += 1
            snippets.append(
                (orid, triplets[i][1], [t[2] for t in triplets[i:j]])
            )
            i = j
        ns = len(snippets)
        if ns == 0:
            return []

        # Bit matrix: which subgraph vertices each snippet visits.
        bits = np.zeros((ns, nv), np.int32)
        for si, (_orid, _f, vs) in enumerate(snippets):
            for v in vs:
                bits[si, v_index[v]] = 1
        pop = bits.sum(axis=1)

        # SnippetGraph edges x -> y when |y - x| <= round(f * |y|):
        # |y & ~x| = |y| - y.x, one matmul for all pairs.
        inter = bits @ bits.T  # (ns, ns)
        zcount = pop[None, :] - inter  # z[x, y] = |y - x|
        thr = np.round(self.fraction_threshold * pop.astype(float)).astype(
            np.int64
        )
        adj_mat = zcount <= thr[None, :]
        np.fill_diagonal(adj_mat, False)
        adj = [list(np.flatnonzero(adj_mat[x])) for x in range(ns)]

        # Condense strongly connected components.
        comp = _tarjan_scc(ns, adj)
        ncomp = int(comp.max()) + 1
        comp_adj: List[set] = [set() for _ in range(ncomp)]
        for x in range(ns):
            for y in adj[x]:
                if comp[x] != comp[y]:
                    comp_adj[comp[x]].add(int(comp[y]))
        comp_in = np.zeros(ncomp, np.int64)
        for c in range(ncomp):
            for d in comp_adj[c]:
                comp_in[d] += 1

        # Ancestor analysis: cluster = vertices descending from exactly
        # one maximal (in-degree-0) component.
        n_ancestors = np.zeros(ncomp, np.int64)
        ancestor_of = np.full(ncomp, -1, np.int64)
        for c in range(ncomp):
            if comp_in[c]:
                continue
            seen = {c}
            q = [c]
            while q:
                x = q.pop()
                for y in comp_adj[x]:
                    if y not in seen:
                        seen.add(y)
                        q.append(y)
            for d in seen:
                n_ancestors[d] += 1
                ancestor_of[d] = c

        clusters: Dict[int, List[int]] = {}
        for c in range(ncomp):
            if n_ancestors[c] == 1:
                clusters.setdefault(int(ancestor_of[c]), []).append(c)

        new_vertices: List[PathGraphVertex] = []
        for _maximal, comps in sorted(clusters.items()):
            comp_set = set(comps)
            snippet_ids = [s for s in range(ns) if comp[s] in comp_set]
            if len(snippet_ids) < self.min_cluster_coverage:
                continue
            # Vertex coverage within the cluster.
            cov = bits[snippet_ids].sum(axis=0)
            kept = [
                subgraph[i]
                for i in range(nv)
                if cov[i] >= self.min_vertex_coverage
            ]
            if not kept:
                continue
            new_vertices.extend(
                self._cluster_paths_to_vertices(kept, snippet_ids, snippets)
            )
        return new_vertices

    def _cluster_paths_to_vertices(
        self,
        kept: List[int],
        snippet_ids: List[int],
        snippets: List[Tuple[int, int, List[int]]],
    ) -> List[PathGraphVertex]:
        """Linear chains of the cluster's induced subgraph (after SCC
        edge removal + transitive reduction) -> new vertices with
        merged journey intervals (reference: findClusterPaths +
        the per-path interval-map construction,
        src/mode3-PathGraph.cpp:1033-1140, 1281-1388)."""
        kindex = {v: i for i, v in enumerate(kept)}
        nk = len(kept)
        edges = set()
        for v0 in kept:
            for v1 in self.out_adj[v0]:
                if v1 in kindex:
                    edges.add((kindex[v0], kindex[v1]))
        comp = _tarjan_scc(nk, [
            [v for (u, v) in edges if u == x] for x in range(nk)
        ])
        edges = {(u, v) for (u, v) in edges if comp[u] != comp[v]}
        edges = _transitive_reduction_dag(nk, edges)
        chains = _linear_vertex_chains(nk, edges)

        # Cluster set: (orid, vertex) pairs covered by the cluster.
        cluster_pairs = set()
        for s in snippet_ids:
            orid, _f, vs = snippets[s]
            for v in vs:
                cluster_pairs.add((orid, v))

        out = []
        for chain in chains:
            chain_vertices = [kept[i] for i in chain]
            nvtx = PathGraphVertex(path=[])
            for v in chain_vertices:
                nvtx.path.extend(self.vertices[v].path)
            # Merge the journey intervals of (orid, v) pairs on this
            # chain into maximal runs per oriented read.
            chain_set = set(chain_vertices)
            per_orid: Dict[int, List[Tuple[int, int]]] = {}
            for orid, v in cluster_pairs:
                if v not in chain_set:
                    continue
                vert = self.vertices[v]
                for o2, first, last in vert.intervals:
                    if o2 == orid:
                        per_orid.setdefault(orid, []).append((first, last))
            for orid, ivals in per_orid.items():
                ivals.sort()
                cur_f, cur_l = ivals[0]
                for f, l in ivals[1:]:
                    if f <= cur_l + 1:
                        cur_l = max(cur_l, l)
                    else:
                        nvtx.intervals.append((orid, cur_f, cur_l))
                        cur_f, cur_l = f, l
                nvtx.intervals.append((orid, cur_f, cur_l))
            out.append(nvtx)
        return out

    def detangle(self) -> int:
        """One detangle iteration over all subgraphs; rebuilds the
        graph from the new vertices (reference: detangle + the
        constructor's iteration, src/mode3-PathGraph.cpp:29-90)."""
        new_vertices: List[PathGraphVertex] = []
        for sid in range(len(self.subgraphs)):
            new_vertices.extend(self.detangle_subgraph(sid))
        if not new_vertices:
            return 0
        self.vertices = new_vertices
        self._rebuild()
        return len(new_vertices)

    # ---- outputs ----

    def write_journeys_csv(self, path: str) -> None:
        with open(path, "w") as f:
            for orid in range(self.n_or):
                f.write(
                    f"{orid // 2}-{orid & 1},"
                    + ",".join(str(v) for v in self.journeys[orid])
                    + ("," if self.journeys[orid] else "")
                    + "\n"
                )

    def write_gfa(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("H\tVN:Z:1.0\n")
            for vi, v in enumerate(self.vertices):
                f.write(f"S\t{vi}\t*\tLN:i:{len(v.path)}\n")
            for (u, v), _cov in sorted(self.edges.items()):
                f.write(f"L\t{u}\t+\t{v}\t+\t*\n")

    def write_detailed_csv(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("VertexId,SubgraphId,PathLength,Coverage,Path\n")
            for vi, v in enumerate(self.vertices):
                sid = (
                    int(self.subgraph_of[vi])
                    if vi < self.subgraph_of.shape[0]
                    else -1
                )
                f.write(
                    f"{vi},{sid},{len(v.path)},{len(v.intervals)},"
                    + " ".join(str(s) for s in v.path)
                    + "\n"
                )

    def write_subgraph_histogram_csv(self, path: str) -> None:
        sizes = np.array([len(s) for s in self.subgraphs], np.int64)
        with open(path, "w") as f:
            f.write("Size,Frequency,Vertices\n")
            if sizes.shape[0] == 0:
                return
            hist = np.bincount(sizes)
            for size, freq in enumerate(hist):
                f.write(f"{size},{freq},{size * freq}\n")


def create_mode3_path_graph(
    m3,
    out_dir: Optional[str] = None,
    min_coverage: int = 3,
    partition_max_distance: int = 10,
    min_subgraph_size: int = 8,
) -> PathGraph:
    """Build, partition and detangle the PathGraph of a mode-3 graph,
    writing the reference's output family when ``out_dir`` is given
    (PathGraphJourneys.csv, PathGraph.gfa, PathGraphDetailed.csv,
    PathGraphSubgraphHistogram.csv, then the -1 variants after one
    detangle iteration)."""
    pg = PathGraph(
        m3.segment_count,
        m3.journey_offsets,
        m3.journey_segments,
        min_coverage=min_coverage,
        partition_max_distance=partition_max_distance,
        min_subgraph_size=min_subgraph_size,
    )
    pg.partition()
    if out_dir is not None:
        pg.write_journeys_csv(os.path.join(out_dir, "PathGraphJourneys.csv"))
        pg.write_gfa(os.path.join(out_dir, "PathGraph.gfa"))
        pg.write_detailed_csv(
            os.path.join(out_dir, "PathGraphDetailed.csv")
        )
        pg.write_subgraph_histogram_csv(
            os.path.join(out_dir, "PathGraphSubgraphHistogram.csv")
        )
    created = pg.detangle()
    if out_dir is not None and created:
        pg.write_journeys_csv(
            os.path.join(out_dir, "PathGraphJourneys-1.csv")
        )
        pg.write_gfa(os.path.join(out_dir, "PathGraph-1.gfa"))
        pg.write_detailed_csv(
            os.path.join(out_dir, "PathGraphDetailed-1.csv")
        )
    return pg
