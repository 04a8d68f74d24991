"""PhasingGraph: Bayesian phasing of diploid bubbles.

Counterpart of the reference PhasingGraph
(reference: src/PhasingGraph.cpp, src/diploidBayesianPhase.cpp).
Vertices are phasing components (initially one per diploid bubble);
each vertex has two read sides. Edges come from reads shared between
vertices — built here as one sparse read-incidence expansion (sort by
read, pairwise wedges, bincount of (pair, sideA, sideB)) instead of
the reference's per-vertex streak loops or an O(B^2) dense product.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from shasta_tpu_torch.graph.mode2 import diploid_bayesian_phase

INVALID = -1


@dataclass
class PGEdge:
    va: int  # vertex indices (va < vb)
    vb: int
    matrix: np.ndarray  # (2, 2) counts
    relative_phase: int = 0
    log_p: float = 0.0
    is_tree_edge: bool = False

    def run_bayesian_model(self, epsilon: float, allow_random: bool) -> None:
        """(reference: PhasingGraphEdge::runBayesianModel,
        src/PhasingGraph.cpp:24)"""
        log_pin, log_pout = diploid_bayesian_phase(self.matrix, epsilon)
        if allow_random:
            if log_pin >= log_pout:
                self.relative_phase = 0
                self.log_p = min(log_pin - log_pout, log_pin)
            else:
                self.relative_phase = 1
                self.log_p = min(log_pout - log_pin, log_pout)
        else:
            self.log_p = abs(log_pin - log_pout)
            self.relative_phase = 0 if log_pin >= log_pout else 1


class PhasingGraph:
    """One vertex per phasing component of diploid phased bubbles."""

    def __init__(
        self,
        g,  # AssemblyGraph2
        min_concordant_read_count: int,
        max_discordant_read_count: int,
        min_log_p: float,
        epsilon: float,
        allow_random_hypothesis: bool,
    ):
        # ----- vertices (reference: createVertices) -----
        # component id -> list of (edge id, bubble phase)
        comp_bubbles: Dict[int, List[Tuple[int, int]]] = {}
        for eid in sorted(g.edges):
            e = g.edges[eid]
            if e.ploidy != 2 or not e.is_phased():
                continue
            comp_bubbles.setdefault(e.component, []).append((eid, e.phase))
        self.component_ids = sorted(comp_bubbles)
        self.bubbles: List[List[Tuple[int, int]]] = [
            comp_bubbles[c] for c in self.component_ids
        ]
        n = len(self.component_ids)

        # Per-vertex read sides: bubble side -> vertex side via the
        # bubble's phase; reads on both sides are dropped.
        self.sides: List[Tuple[np.ndarray, np.ndarray]] = []
        for bubbles in self.bubbles:
            acc = [[], []]
            for eid, phase in bubbles:
                e = g.edges[eid]
                for bubble_side in (0, 1):
                    vertex_side = bubble_side if phase == 0 else 1 - bubble_side
                    r = e.branches[bubble_side].reads
                    if r is not None and r.shape[0]:
                        acc[vertex_side].append(r)
            s0 = np.unique(np.concatenate(acc[0])) if acc[0] else np.zeros(0, np.int64)
            s1 = np.unique(np.concatenate(acc[1])) if acc[1] else np.zeros(0, np.int64)
            common = np.intersect1d(s0, s1)
            if common.shape[0]:
                s0 = np.setdiff1d(s0, common)
                s1 = np.setdiff1d(s1, common)
            self.sides.append((s0, s1))

        # ----- edges (sparse read-incidence expansion) -----
        self.edges: List[PGEdge] = []
        self.phase_v = np.full(n, INVALID, np.int64)
        self.component_v = np.full(n, INVALID, np.int64)
        if n == 0:
            return
        inc_read, inc_v, inc_side = [], [], []
        for i, (s0, s1) in enumerate(self.sides):
            inc_read.append(s0)
            inc_v.append(np.full(s0.shape[0], i, np.int64))
            inc_side.append(np.zeros(s0.shape[0], np.int64))
            inc_read.append(s1)
            inc_v.append(np.full(s1.shape[0], i, np.int64))
            inc_side.append(np.ones(s1.shape[0], np.int64))
        read = np.concatenate(inc_read)
        vert = np.concatenate(inc_v)
        side = np.concatenate(inc_side)
        if read.shape[0] == 0:
            return
        # Sort incidences by (read, vertex): pairwise expansion within
        # each read group gives va < vb automatically.
        order = np.lexsort((vert, read))
        read, vert, side = read[order], vert[order], side[order]
        N = read.shape[0]
        grp_new = np.empty(N, bool)
        grp_new[0] = True
        np.not_equal(read[1:], read[:-1], out=grp_new[1:])
        gid = np.cumsum(grp_new) - 1
        gsize = np.bincount(gid)
        starts = np.concatenate(([0], np.cumsum(gsize)))[:-1]
        # Each incidence pairs with every LATER incidence of its group.
        rank = np.arange(N, dtype=np.int64) - starts[gid]
        first_count = gsize[gid] - 1 - rank
        total = int(first_count.sum())
        if total == 0:
            return
        ia = np.repeat(np.arange(N, dtype=np.int64), first_count)
        off = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(first_count)))[:-1], first_count
        )
        ib = ia + 1 + off
        va, vb = vert[ia], vert[ib]
        sa, sb = side[ia], side[ib]
        ok = va != vb
        va, vb, sa, sb = va[ok], vb[ok], sa[ok], sb[ok]

        key = (va * n + vb) * 4 + sa * 2 + sb
        uniq_keys, key_counts = np.unique(key, return_counts=True)
        pair_key = uniq_keys // 4
        cell = uniq_keys % 4
        uniq_pairs, pair_inv = np.unique(pair_key, return_inverse=True)
        mats = np.zeros((uniq_pairs.shape[0], 2, 2), np.int64)
        mats[pair_inv, cell // 2, cell % 2] = key_counts

        for pi in range(uniq_pairs.shape[0]):
            m = mats[pi]
            diag = int(m[0, 0] + m[1, 1])
            off = int(m[0, 1] + m[1, 0])
            concordant = max(diag, off)
            discordant = min(diag, off)
            if concordant < min_concordant_read_count:
                continue
            if discordant > max_discordant_read_count:
                continue
            edge = PGEdge(
                va=int(uniq_pairs[pi] // n),
                vb=int(uniq_pairs[pi] % n),
                matrix=m,
            )
            edge.run_bayesian_model(epsilon, allow_random_hypothesis)
            if edge.log_p > min_log_p:
                self.edges.append(edge)

    @property
    def vertex_count(self) -> int:
        return len(self.component_ids)

    @property
    def edge_count(self) -> int:
        return len(self.edges)

    def compute_spanning_tree(self) -> None:
        """Maximum-logP spanning forest, Kruskal (reference:
        computeSpanningTree, src/PhasingGraph.cpp:353)."""
        n = self.vertex_count
        parent = list(range(n))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        order = sorted(
            range(len(self.edges)), key=lambda i: (-self.edges[i].log_p, i)
        )
        for i in order:
            e = self.edges[i]
            ra, rb = find(e.va), find(e.vb)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
                e.is_tree_edge = True

    def phase(self) -> int:
        """BFS phase propagation over tree edges (reference: phase,
        src/PhasingGraph.cpp:396). Returns component count."""
        from collections import deque

        n = self.vertex_count
        adj: Dict[int, List[Tuple[int, int]]] = {}
        for e in self.edges:
            if not e.is_tree_edge:
                continue
            adj.setdefault(e.va, []).append((e.vb, e.relative_phase))
            adj.setdefault(e.vb, []).append((e.va, e.relative_phase))
        comp = 0
        for start in range(n):
            if self.component_v[start] != INVALID:
                continue
            q = deque([start])
            self.component_v[start] = comp
            self.phase_v[start] = 0
            while q:
                v0 = q.popleft()
                for v1, rel in adj.get(v0, ()):
                    if self.component_v[v1] != INVALID:
                        continue
                    self.component_v[v1] = comp
                    self.phase_v[v1] = (
                        self.phase_v[v0] if rel == 0 else 1 - self.phase_v[v0]
                    )
                    q.append(v1)
            comp += 1
        return comp

    def store_phasing(self, g) -> None:
        """Write component/phase back to the bubbles (reference:
        storePhasing, src/PhasingGraph.cpp:507)."""
        for e in g.edges.values():
            e.component = INVALID
            e.phase = INVALID
        for vi in range(self.vertex_count):
            for eid, bubble_phase in self.bubbles[vi]:
                if eid not in g.edges:
                    continue
                edge = g.edges[eid]
                edge.component = int(self.component_v[vi])
                phase = int(self.phase_v[vi])
                if bubble_phase == 1:
                    phase = 1 - phase
                edge.phase = phase
