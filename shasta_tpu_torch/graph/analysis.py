"""Analysis structures: compressed assembly graph, induced alignments,
marker connectivity.

Counterparts of the reference's on-demand analysis structures:

- CompressedAssemblyGraph (reference:
  src/CompressedAssemblyGraph.{hpp,cpp}): condensation of the assembly
  graph in which each linear chain of *bubbles* becomes one edge —
  used for large-scale structure analysis and display only.
- Induced alignments (reference: src/InducedAlignment.{hpp,cpp},
  src/AssemblerInducedAlignments.cpp): the alignment between two
  oriented reads implied by the marker-graph vertices they share.
- MarkerConnectivityGraph (reference: src/MarkerConnectivityGraph.hpp):
  connects (oriented read, ordinal) marker pairs that belong to the
  same marker-graph vertex.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph
from shasta_tpu_torch.graph.marker_graph import MarkerGraph


# ---------------------------------------------------------------------------
# Induced alignments
# ---------------------------------------------------------------------------


def induced_alignment(
    markers: MarkerStore, mg: MarkerGraph, orid0: int, orid1: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Ordinal pairs of the two oriented reads that share a marker
    graph vertex, ordered by ordinal0 (reference:
    Assembler::computeInducedAlignment)."""
    moff = markers.offsets
    vt = mg.vertex_table

    def vertices_of(orid):
        lo, hi = moff[orid], moff[orid + 1]
        v = vt[lo:hi]
        ords = np.arange(hi - lo, dtype=np.int64)
        sel = v >= 0
        return v[sel], ords[sel]

    v0, o0 = vertices_of(orid0)
    v1, o1 = vertices_of(orid1)
    # Join on vertex id (vertices can repeat if duplicate markers were
    # allowed; use sorted merge producing all matching pairs once).
    order1 = np.argsort(v1, kind="stable")
    v1s, o1s = v1[order1], o1[order1]
    lo_idx = np.searchsorted(v1s, v0, side="left")
    hi_idx = np.searchsorted(v1s, v0, side="right")
    reps = hi_idx - lo_idx
    take = np.repeat(lo_idx, reps) + (
        np.arange(int(reps.sum())) -
        np.repeat(np.concatenate(([0], np.cumsum(reps)))[:-1], reps)
    )
    out0 = np.repeat(o0, reps)
    out1 = o1s[take]
    order = np.argsort(out0, kind="stable")
    return out0[order], out1[order]


def marker_connectivity_pairs(
    markers: MarkerStore, mg: MarkerGraph
) -> Tuple[np.ndarray, np.ndarray]:
    """All (marker, marker) pairs connected by sharing a vertex,
    returned as two flat global-marker-id arrays (consecutive in-vertex
    markers chained — the transitive closure is the vertex itself),
    (reference: MarkerConnectivityGraph.hpp)."""
    vm = mg.vertex_markers
    offs = mg.vertex_offsets
    cov = np.diff(offs)
    # Chain consecutive markers within each vertex.
    keep = np.ones(vm.shape[0], dtype=bool)
    if vm.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    starts = offs[:-1]
    keep[starts[cov > 0]] = False  # first in each vertex has no predecessor
    u = vm[np.flatnonzero(keep) - 1]
    v = vm[keep]
    return u, v


# ---------------------------------------------------------------------------
# Compressed assembly graph (bubble-chain condensation)
# ---------------------------------------------------------------------------


@dataclass
class CompressedAssemblyGraph:
    """Each edge is a maximal chain of single-entry/single-exit
    'bubble' groups of assembly edges; vertices are the branching
    marker-graph vertices that remain."""

    # Per compressed edge: source/target marker-graph vertex id and the
    # list of assembly-graph edge ids it swallows.
    source_v: np.ndarray
    target_v: np.ndarray
    member_offsets: np.ndarray  # CSR into members
    members: np.ndarray  # assembly edge ids

    @property
    def edge_count(self) -> int:
        return self.source_v.shape[0]

    def members_of(self, e: int) -> np.ndarray:
        return self.members[self.member_offsets[e] : self.member_offsets[e + 1]]


def compress_assembly_graph(ag: AssemblyGraph) -> CompressedAssemblyGraph:
    """Bubble-chain condensation (reference:
    CompressedAssemblyGraph.cpp): group parallel assembly edges by
    (source, target) into 'bundles'; then merge maximal linear chains
    of bundles (internal vertices with exactly one bundle in and out)."""
    # Bundles.
    groups: Dict[Tuple[int, int], List[int]] = {}
    for e in range(ag.edge_count):
        groups.setdefault(
            (int(ag.source_v[e]), int(ag.target_v[e])), []
        ).append(e)
    bundles = sorted(groups.items())
    nb = len(bundles)
    b_src = np.array([k[0] for k, _ in bundles], np.int64)
    b_tgt = np.array([k[1] for k, _ in bundles], np.int64)

    # Vertex degrees over bundles.
    verts = np.unique(np.concatenate([b_src, b_tgt])) if nb else np.zeros(0, np.int64)
    out_deg = {int(v): 0 for v in verts}
    in_deg = {int(v): 0 for v in verts}
    out_of: Dict[int, int] = {}
    in_of: Dict[int, int] = {}
    for i in range(nb):
        out_deg[int(b_src[i])] += 1
        in_deg[int(b_tgt[i])] += 1
        out_of[int(b_src[i])] = i
        in_of[int(b_tgt[i])] = i

    def next_bundle(i: int):
        t = int(b_tgt[i])
        if out_deg.get(t) == 1 and in_deg.get(t) == 1 and t != int(b_src[i]):
            return out_of[t]
        return None

    def prev_bundle(i: int):
        s = int(b_src[i])
        if out_deg.get(s) == 1 and in_deg.get(s) == 1 and s != int(b_tgt[i]):
            return in_of[s]
        return None

    used = [False] * nb
    src_out, tgt_out, member_lists = [], [], []
    for start in range(nb):
        if used[start]:
            continue
        chain = [start]
        used[start] = True
        i = start
        while True:
            j = next_bundle(i)
            if j is None or used[j]:
                break
            chain.append(j)
            used[j] = True
            i = j
        i = start
        while True:
            j = prev_bundle(i)
            if j is None or used[j]:
                break
            chain.insert(0, j)
            used[j] = True
            i = j
        members = []
        for b in chain:
            members.extend(bundles[b][1])
        src_out.append(int(b_src[chain[0]]))
        tgt_out.append(int(b_tgt[chain[-1]]))
        member_lists.append(np.array(members, np.int64))

    offsets = np.zeros(len(member_lists) + 1, np.int64)
    for i, m in enumerate(member_lists):
        offsets[i + 1] = offsets[i] + m.shape[0]
    return CompressedAssemblyGraph(
        source_v=np.array(src_out, np.int64),
        target_v=np.array(tgt_out, np.int64),
        member_offsets=offsets,
        members=(
            np.concatenate(member_lists) if member_lists else np.zeros(0, np.int64)
        ),
    )
