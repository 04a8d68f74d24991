"""Marker graph simplification: bubble and superbubble removal.

Counterpart of the reference simplifyMarkerGraph
(reference: src/AssemblerMarkerGraph.cpp:3706-4460). Each iteration
uses one maxLength value (Assembly.simplifyMaxLength, e.g.
"10,100,1000") and has two parts, each over a freshly condensed
temporary assembly graph:

- Part 1 (bubbles, :3775): for every set of parallel assembly edges
  of length <= maxLength between the same vertex pair, keep only the
  one with highest average marker-edge coverage.
- Part 2 (superbubbles, :3903): connected components over assembly
  edges of length <= maxLength; entries/exits are vertices with
  cross-component (or long) in/out edges; keep only edges on
  highest-coverage (weight = 1/averageCoverage) shortest paths from
  each entry to each exit; drop everything else in the component.

All removals flag the marker-graph edges of the dropped chains (and
their reverse complements) as superbubble edges, keeping the graph
strand-symmetric.

This is a host-side condensed-graph pass, sequential in the reference
too; sizes are tiny compared to the marker graph.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np

from shasta_tpu_torch.graph.assembly_graph import (
    AssemblyGraph,
    chain_mean_coverage,
    create_assembly_graph,
)
from shasta_tpu_torch.graph.marker_graph import MarkerGraph


class _TempGraph:
    """Vertex-indexed view of a condensed assembly graph with the
    attributes Part 1/2 need."""

    def __init__(self, ag: AssemblyGraph, mg: MarkerGraph):
        self.ag = ag
        n_e = ag.edge_count
        # Assembly vertices: unique marker-graph vertex ids.
        all_v = np.concatenate([ag.source_v, ag.target_v])
        self.verts = np.unique(all_v) if all_v.size else np.zeros(0, np.int64)
        self.src = np.searchsorted(self.verts, ag.source_v)
        self.tgt = np.searchsorted(self.verts, ag.target_v)
        self.n_v = self.verts.shape[0]

        # Average marker-edge coverage per assembly edge (reference:
        # createAssemblyGraphVertices coverage metrics; integer mean).
        self.length = np.diff(ag.chain_offsets)
        self.avg_cov = chain_mean_coverage(ag, mg.coverage)

        # Reverse complement of an assembly vertex.
        rc_marker_v = mg.rc_vertex[self.verts]
        self.rc_vert = np.searchsorted(self.verts, rc_marker_v)

        # Adjacency.
        self.out_edges: List[List[int]] = [[] for _ in range(self.n_v)]
        self.in_edges: List[List[int]] = [[] for _ in range(self.n_v)]
        for e in range(n_e):
            self.out_edges[self.src[e]].append(e)
            self.in_edges[self.tgt[e]].append(e)


def _flag_chain(mg: MarkerGraph, ag: AssemblyGraph, e: int) -> None:
    chain = ag.chain(e)
    mg.superbubble[chain] = True
    rc = mg.rc_edge[chain]
    mg.superbubble[rc[rc >= 0]] = True


def simplify_iteration_part1(mg: MarkerGraph, max_length: int) -> int:
    """Bubble removal (reference: simplifyMarkerGraphIterationPart1)."""
    ag = create_assembly_graph(mg)
    g = _TempGraph(ag, mg)
    removed = 0

    keep = np.ones(ag.edge_count, dtype=bool)
    for v0 in range(g.n_v):
        edges = g.out_edges[v0]
        if any(g.length[e] > max_length for e in edges):
            continue
        by_target: Dict[int, List[int]] = {}
        for e in edges:
            by_target.setdefault(int(g.tgt[e]), []).append(e)
        for v1, es in by_target.items():
            if v1 == g.rc_vert[v0]:
                continue  # rc pair: special-cased by the reference too
            if len(es) < 2:
                continue
            # Keep highest average coverage; ties -> lowest edge id.
            es.sort(key=lambda e: (-g.avg_cov[e], e))
            for e in es[1:]:
                keep[e] = False

    for e in np.flatnonzero(~keep):
        _flag_chain(mg, ag, int(e))
        removed += 1
    return removed


def simplify_iteration_part2(mg: MarkerGraph, max_length: int) -> int:
    """Superbubble removal (reference: simplifyMarkerGraphIterationPart2)."""
    ag = create_assembly_graph(mg)
    g = _TempGraph(ag, mg)
    n_v = g.n_v
    n_e = ag.edge_count
    if n_e == 0:
        return 0

    # Components over short edges.
    parent = list(range(n_v))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in range(n_e):
        if g.length[e] <= max_length:
            ra, rb = find(int(g.src[e])), find(int(g.tgt[e]))
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

    comp = np.array([find(v) for v in range(n_v)], dtype=np.int64)

    keep = np.zeros(n_e, dtype=bool)
    long_e = g.length > max_length
    cross = comp[g.src] != comp[g.tgt]
    keep |= long_e | cross

    # Entries and exits.
    is_entry = np.zeros(n_v, dtype=bool)
    is_exit = np.zeros(n_v, dtype=bool)
    for v0 in range(n_v):
        for e in g.in_edges[v0]:
            if g.length[e] > max_length or comp[g.src[e]] != comp[v0]:
                is_entry[v0] = True
                break
        for e in g.out_edges[v0]:
            if g.length[e] > max_length or comp[g.tgt[e]] != comp[v0]:
                is_exit[v0] = True
                break

    # Group vertices per component.
    members: Dict[int, List[int]] = {}
    for v in range(n_v):
        members.setdefault(int(comp[v]), []).append(v)

    def keep_internal(vs):
        for v0 in vs:
            for e in g.out_edges[v0]:
                if comp[g.tgt[e]] == comp[v0] and g.length[e] <= max_length:
                    keep[e] = True
                    keep[ag.rc_edge[e]] = True

    for cid, vs in members.items():
        # Reverse complement component.
        rc_cid = int(comp[g.rc_vert[vs[0]]])
        if rc_cid == cid:
            # Self-complementary: keep all internal edges.
            keep_internal(vs)
            continue
        if rc_cid < cid:
            continue  # processed via the rc component

        entries = [v for v in vs if is_entry[v]]
        exits = [v for v in vs if is_exit[v]]
        if not entries or not exits:
            keep_internal(vs)
            continue

        # Internal adjacency for Dijkstra (weight = 1/avg coverage).
        local = {v: i for i, v in enumerate(vs)}
        adj: List[List[Tuple[int, float, int]]] = [[] for _ in vs]
        for v0 in vs:
            for e in g.out_edges[v0]:
                v1 = int(g.tgt[e])
                if v1 in local and g.length[e] <= max_length:
                    w = 1.0 / max(1, g.avg_cov[e])
                    adj[local[v0]].append((local[v1], w, e))

        for entry in entries:
            # Dijkstra with predecessor tree.
            src = local[entry]
            dist = [np.inf] * len(vs)
            pred = [-1] * len(vs)
            dist[src] = 0.0
            q = [(0.0, src)]
            while q:
                d, u = heapq.heappop(q)
                if d > dist[u]:
                    continue
                for v, w, e in adj[u]:
                    nd = d + w
                    if nd < dist[v]:
                        dist[v] = nd
                        pred[v] = u
                        heapq.heappush(q, (nd, v))

            for exit_v in exits:
                if exit_v == entry:
                    continue
                t = local[exit_v]
                if pred[t] == -1:
                    continue  # unreachable
                # Walk back; keep the best (highest coverage) edge for
                # each (v0, v1) step, plus its reverse complement.
                v1 = t
                while True:
                    v0 = pred[v1]
                    if v0 == -1:
                        break
                    best_e, best_cov = -1, 0
                    for vv, w, e in adj[v0]:
                        if vv == v1 and g.avg_cov[e] > best_cov:
                            best_cov = g.avg_cov[e]
                            best_e = e
                    if best_e >= 0:
                        keep[best_e] = True
                        keep[ag.rc_edge[best_e]] = True
                    if v0 == src:
                        break
                    v1 = v0

    removed = 0
    for e in np.flatnonzero(~keep):
        _flag_chain(mg, ag, int(e))
        removed += 1
    return removed


def simplify_marker_graph(
    mg: MarkerGraph, max_lengths: List[int]
) -> Dict[str, int]:
    """Run all simplify iterations (reference: simplifyMarkerGraph,
    src/AssemblerMarkerGraph.cpp:3706)."""
    mg.superbubble[:] = False
    stats = {"bubbles_removed": 0, "superbubble_edges_removed": 0}
    for max_length in max_lengths:
        stats["bubbles_removed"] += simplify_iteration_part1(mg, max_length)
        stats["superbubble_edges_removed"] += simplify_iteration_part2(
            mg, max_length
        )
    return stats
