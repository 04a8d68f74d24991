"""AssemblyGraph2: the full mode-2 (phased diploid) assembly graph.

Counterpart of the reference's AssemblyGraph2 pipeline
(reference: src/AssemblyGraph2.cpp:44-233 constructor sequence,
src/PhasingGraph.cpp, src/diploidBayesianPhase.cpp). The condensed
graph is small (segments, not markers), so these passes run on host —
same division of labor as the reference, which runs them on one
thread except storeReadInformation/assemble. The compute-heavy parts
(branch sequence assembly, read-support gathering) reuse the
vectorized marker-graph machinery.

Pipeline implemented here (constructor order of the reference):
create -> prune -> removeShortLoopbackEdges -> gatherBubbles ->
handleSuperbubbles0/1 (dominator-tree chunking + path enumeration) ->
storeReadInformation -> removeWeakBranches -> forceMaximumPloidy(2) ->
assemble -> removeDegenerateBranches -> removeBadBubblesIterative ->
hierarchicalPhase -> findBubbleChains -> findPhasingRegions ->
storeGfaSequence -> writers (Detailed/Haploid/Phased x
gfa/NoSequence.gfa/fasta/csv) -> hetSnpStatistics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.graph.marker_graph import MarkerGraph

INVALID = -1


# ---------------------------------------------------------------------------
# Data model
# ---------------------------------------------------------------------------


@dataclass
class Branch:
    """One branch of an AssemblyGraph2 edge (reference:
    AssemblyGraph2Edge::Branch, src/AssemblyGraph2.hpp)."""

    path: np.ndarray  # marker-graph edge ids
    contains_secondary: bool = False
    reads: Optional[np.ndarray] = None  # sorted oriented read ids
    minimum_coverage: int = 0
    coverage_sum: int = 0
    raw_sequence: Optional[np.ndarray] = None  # uint8 base codes
    gfa_sequence: Optional[np.ndarray] = None

    def average_coverage(self) -> int:
        return self.coverage_sum // max(len(self.path), 1)


@dataclass
class AG2Edge:
    """An AssemblyGraph2 edge holding 1..n branches (a bubble when
    ploidy >= 2)."""

    id: int
    v0: int  # marker-graph vertex ids
    v1: int
    branches: List[Branch]
    component: int = INVALID  # phasing component
    phase: int = INVALID  # haplotype of branch 0 when phased

    @property
    def ploidy(self) -> int:
        return len(self.branches)

    def is_bubble(self) -> bool:
        return len(self.branches) > 1

    def is_phased(self) -> bool:
        return self.component != INVALID

    def strongest_branch_id(self) -> int:
        best, best_cov = 0, -1
        for i, b in enumerate(self.branches):
            cov = b.average_coverage()
            if cov > best_cov:
                best, best_cov = i, cov
        return best

    def max_path_length(self) -> int:
        return max(len(b.path) for b in self.branches)

    def min_path_length(self) -> int:
        return min(len(b.path) for b in self.branches)

    def path_id(self, branch_id: int) -> str:
        if self.is_bubble():
            return f"{self.id}.{branch_id}"
        return str(self.id)


@dataclass
class PhasingRegion:
    first_position: int
    last_position: int
    is_phased: bool
    component: int = INVALID


@dataclass
class BubbleChain:
    edges: List[int]  # AG2 edge ids, in order
    phasing_regions: List[PhasingRegion] = field(default_factory=list)


class AssemblyGraph2:
    """Mutable host-side assembly graph keyed by marker-graph vertex
    ids, with incremental adjacency."""

    def __init__(self, mg: MarkerGraph, markers: MarkerStore, k: int):
        self.mg = mg
        self.markers = markers
        self.k = k
        self.edges: Dict[int, AG2Edge] = {}
        self.next_id = 0
        self._out: Dict[int, Set[int]] = {}
        self._in: Dict[int, Set[int]] = {}
        self.bubble_chains: List[BubbleChain] = []
        self.chain_of_edge: Dict[int, Tuple[int, int]] = {}  # eid -> (chain, pos)
        # Per-bubble transfer counts for GFA sequence (reference:
        # countTransferredBases).
        self._backward_transfer: Dict[int, int] = {}
        self._forward_transfer: Dict[int, int] = {}
        self.stats: Dict[str, float] = {}

    # ----- graph mutation -----

    def add_edge(self, v0: int, v1: int, branches: List[Branch]) -> int:
        eid = self.next_id
        self.next_id += 1
        self.edges[eid] = AG2Edge(id=eid, v0=v0, v1=v1, branches=branches)
        self._out.setdefault(v0, set()).add(eid)
        self._in.setdefault(v1, set()).add(eid)
        return eid

    def remove_edge(self, eid: int) -> None:
        e = self.edges.pop(eid)
        self._out[e.v0].discard(eid)
        self._in[e.v1].discard(eid)

    def out_edges(self, v: int) -> List[int]:
        return sorted(self._out.get(v, ()))

    def in_edges(self, v: int) -> List[int]:
        return sorted(self._in.get(v, ()))

    def out_degree(self, v: int) -> int:
        return len(self._out.get(v, ()))

    def in_degree(self, v: int) -> int:
        return len(self._in.get(v, ()))

    def vertices(self) -> List[int]:
        vs = set()
        for e in self.edges.values():
            vs.add(e.v0)
            vs.add(e.v1)
        return sorted(vs)

    # ----- creation (reference: AssemblyGraph2::create) -----

    def create(self) -> None:
        """One edge per maximal linear chain of alive marker-graph
        edges, both strands included (the reference graph is
        strand-symmetric with no explicit rc pairing)."""
        from shasta_tpu_torch.graph.assembly_graph import create_assembly_graph

        ag = create_assembly_graph(self.mg)
        is_secondary = getattr(self.mg, "is_secondary", None)
        for a in range(ag.edge_count):
            chain = ag.chain(a).copy()
            contains_secondary = bool(
                is_secondary is not None and is_secondary[chain].any()
            )
            self.add_edge(
                int(ag.source_v[a]),
                int(ag.target_v[a]),
                [Branch(path=chain, contains_secondary=contains_secondary)],
            )

    # ----- simple transformations -----

    def prune(self, prune_length: int) -> int:
        """Iteratively remove leaf edges whose shortest branch is
        shorter than prune_length markers (reference:
        AssemblyGraph2::prune, src/AssemblyGraph2.cpp:408)."""
        if prune_length <= 0:
            return 0
        removed = 0
        while True:
            to_remove = []
            for eid, e in self.edges.items():
                is_leaf = self.in_degree(e.v0) == 0 or self.out_degree(e.v1) == 0
                if not is_leaf:
                    continue
                if e.min_path_length() < prune_length:
                    to_remove.append(eid)
            if not to_remove:
                break
            for eid in to_remove:
                self.remove_edge(eid)
            removed += len(to_remove)
        return removed

    def remove_short_loopback_edges(self, threshold: int) -> int:
        """(reference: removeShortLoopbackEdges,
        src/AssemblyGraph2.cpp:4579)"""
        bad = [
            eid
            for eid, e in self.edges.items()
            if e.v0 == e.v1 and e.max_path_length() <= threshold
        ]
        for eid in bad:
            self.remove_edge(eid)
        return len(bad)

    def gather_bubbles(self) -> int:
        """Merge sets of >= 2 parallel edges v0->v1 into one bubble
        edge with all their branches (reference: gatherBubbles,
        src/AssemblyGraph2.cpp:840)."""
        n_bubbles = 0
        for v0 in list(self._out.keys()):
            groups: Dict[int, List[int]] = {}
            for eid in self.out_edges(v0):
                groups.setdefault(self.edges[eid].v1, []).append(eid)
            for v1, eids in sorted(groups.items()):
                if len(eids) < 2:
                    continue
                branches: List[Branch] = []
                for eid in eids:
                    branches.extend(self.edges[eid].branches)
                    self.remove_edge(eid)
                self.add_edge(v0, v1, branches)
                n_bubbles += 1
        return n_bubbles

    def find_non_bubble_linear_chains(self) -> List[List[int]]:
        """Linear chains (length >= 2) of non-bubble edges whose
        internal vertices have in-degree and out-degree 1
        (reference: findNonBubbleLinearChains,
        src/AssemblyGraph2.cpp:2776)."""
        chains = []
        seen: Set[int] = set()
        for start in sorted(self.edges):
            if start in seen or self.edges[start].is_bubble():
                continue
            # Extend backward.
            chain = [start]
            e = self.edges[start]
            v = e.v0
            while (
                self.in_degree(v) == 1
                and self.out_degree(v) == 1
            ):
                prev = self.in_edges(v)[0]
                if prev in seen or prev == chain[0] or self.edges[prev].is_bubble():
                    break
                if prev in chain:
                    break  # cycle
                chain.insert(0, prev)
                v = self.edges[prev].v0
            # Extend forward.
            v = e.v1
            while (
                self.in_degree(v) == 1
                and self.out_degree(v) == 1
            ):
                nxt = self.out_edges(v)[0]
                if nxt in seen or self.edges[nxt].is_bubble() or nxt in chain:
                    break
                chain.append(nxt)
                v = self.edges[nxt].v1
            seen.update(chain)
            if len(chain) >= 2:
                chains.append(chain)
        return chains

    def merge(self, store_reads: bool, assemble: bool) -> int:
        """Merge consecutive non-bubble edges (reference: merge,
        src/AssemblyGraph2.cpp:2529)."""
        n = 0
        for chain in self.find_non_bubble_linear_chains():
            path = np.concatenate(
                [self.edges[eid].branches[0].path for eid in chain]
            )
            contains_secondary = any(
                self.edges[eid].branches[0].contains_secondary for eid in chain
            )
            v0 = self.edges[chain[0]].v0
            v1 = self.edges[chain[-1]].v1
            for eid in chain:
                self.remove_edge(eid)
            new_id = self.add_edge(
                v0, v1, [Branch(path=path, contains_secondary=contains_secondary)]
            )
            e = self.edges[new_id]
            if store_reads:
                self.store_read_information_edge(e)
            if assemble:
                self.assemble_edge(e)
            n += 1
        return n

    # ----- read information + assembly -----

    def store_read_information_edge(self, e: AG2Edge) -> None:
        mg = self.mg
        for b in e.branches:
            if b.path.shape[0] == 0:
                b.reads = np.zeros(0, np.int64)
                b.minimum_coverage = 0
                b.coverage_sum = 0
                continue
            lo = mg.interval_offsets[b.path]
            hi = mg.interval_offsets[b.path + 1]
            n_per = hi - lo
            idx = np.repeat(lo, n_per) + (
                np.arange(int(n_per.sum()), dtype=np.int64)
                - np.repeat(np.concatenate(([0], np.cumsum(n_per)))[:-1], n_per)
            )
            b.reads = np.unique(mg.interval_orid[idx])
            b.minimum_coverage = int(n_per.min())
            b.coverage_sum = int(n_per.sum())

    def store_read_information(self) -> None:
        """All branches in ONE batched segmented pass (reference runs
        storeReadInformationParallel multithreaded,
        src/AssemblyGraph2.cpp:44-233; here the per-branch loops become
        reduceat/unique over branch-concatenated arrays, so host time
        stays flat as the bubble count grows)."""
        mg = self.mg
        branches = [b for e in self.edges.values() for b in e.branches]
        sel = []
        for b in branches:
            if b.path.shape[0] == 0:
                b.reads = np.zeros(0, np.int64)
                b.minimum_coverage = 0
                b.coverage_sum = 0
            else:
                sel.append(b)
        if not sel:
            return
        blens = np.array([b.path.shape[0] for b in sel], np.int64)
        bstarts = np.zeros(len(sel) + 1, np.int64)
        np.cumsum(blens, out=bstarts[1:])
        path_cat = np.concatenate([b.path for b in sel]).astype(np.int64)
        lo = mg.interval_offsets[path_cat]
        n_per = (mg.interval_offsets[path_cat + 1] - lo).astype(np.int64)
        mincov = np.minimum.reduceat(n_per, bstarts[:-1])
        covsum = np.add.reduceat(n_per, bstarts[:-1])
        # Expand every marker interval of every path element.
        tot = int(n_per.sum())
        elem_starts = np.zeros(path_cat.shape[0] + 1, np.int64)
        np.cumsum(n_per, out=elem_starts[1:])
        idx = np.repeat(lo, n_per) + (
            np.arange(tot, dtype=np.int64) - np.repeat(elem_starts[:-1], n_per)
        )
        orid = mg.interval_orid[idx].astype(np.int64)
        per_branch = covsum  # intervals per branch == coverage sum
        branch_of = np.repeat(
            np.arange(len(sel), dtype=np.int64), per_branch
        )
        # unique oriented reads per branch: one global sort of the
        # combined (branch, orid) key.
        n_or = int(orid.max()) + 1 if tot else 1
        ukey = np.unique(branch_of * n_or + orid)
        ub = ukey // n_or
        uo = ukey % n_or
        cuts = np.searchsorted(ub, np.arange(len(sel) + 1))
        for i, b in enumerate(sel):
            b.reads = uo[cuts[i] : cuts[i + 1]]
            b.minimum_coverage = int(mincov[i])
            b.coverage_sum = int(covsum[i])

    def set_assembler(self, fn: Callable[[np.ndarray], np.ndarray]) -> None:
        """fn(path of marker-graph edge ids) -> raw uint8 sequence."""
        self._assemble_fn = fn

    def assemble_edge(self, e: AG2Edge) -> None:
        for b in e.branches:
            b.raw_sequence = self._assemble_fn(b.path)

    def assemble_all(self) -> None:
        for e in self.edges.values():
            self.assemble_edge(e)

    # ----- branch cleanup -----

    def remove_weak_branches(self, strong_branch_threshold: int) -> int:
        """(reference: removeWeakBranches, src/AssemblyGraph2.cpp:2304)"""
        n = 0
        for e in self.edges.values():
            if not e.is_bubble():
                continue
            strongest = e.strongest_branch_id()
            kept = [
                b
                for i, b in enumerate(e.branches)
                if i == strongest
                or (b.reads is not None and b.reads.shape[0] >= strong_branch_threshold)
            ]
            n += len(e.branches) - len(kept)
            e.branches = kept
        return n

    def force_maximum_ploidy(self, max_ploidy: int) -> None:
        """(reference: forceMaximumPloidy, src/AssemblyGraph2.cpp:2392)"""
        for e in self.edges.values():
            if e.ploidy <= max_ploidy:
                continue
            order = sorted(
                range(e.ploidy),
                key=lambda i: (-e.branches[i].average_coverage(), i),
            )
            e.branches = [e.branches[i] for i in order[:max_ploidy]]

    def remove_degenerate_branches(self) -> int:
        """Branches of a bubble with identical raw sequence collapse
        to the strongest (reference: removeDegenerateBranches,
        src/AssemblyGraph2.cpp:2407)."""
        n = 0
        for e in self.edges.values():
            if e.ploidy < 2:
                continue
            groups: Dict[bytes, List[int]] = {}
            for i, b in enumerate(e.branches):
                key = (
                    b.raw_sequence.tobytes()
                    if b.raw_sequence is not None
                    else bytes()
                )
                groups.setdefault(key, []).append(i)
            keep = []
            for ids in groups.values():
                best = max(
                    ids, key=lambda i: (e.branches[i].average_coverage(), -i)
                )
                keep.append(best)
            if len(keep) < e.ploidy:
                n += e.ploidy - len(keep)
                e.branches = [e.branches[i] for i in sorted(keep)]
        return n

    # ----- superbubbles -----

    def handle_superbubbles0(
        self,
        edge_length_threshold: int,
        max_size: int,
        max_chunk_size: int,
        max_chunk_path_count: int,
        store_reads: bool,
        assemble: bool,
    ) -> None:
        """Components of short edges form superbubbles (reference:
        handleSuperbubbles0, src/AssemblyGraph2.cpp:3130)."""
        label: Dict[int, int] = {}

        def find(v):
            root = v
            while label.get(root, root) != root:
                root = label[root]
            while label.get(v, v) != root:
                label[v], v = root, label[v]
            return root

        for e in self.edges.values():
            if e.max_path_length() <= edge_length_threshold:
                ra, rb = find(e.v0), find(e.v1)
                if ra != rb:
                    label[max(ra, rb)] = min(ra, rb)
        comps: Dict[int, List[int]] = {}
        for v in self.vertices():
            comps.setdefault(find(v), []).append(v)
        for root in sorted(comps):
            self._handle_superbubble(
                comps[root], edge_length_threshold,
                max_size, max_chunk_size, max_chunk_path_count,
                store_reads, assemble,
            )

    def handle_superbubbles1(
        self,
        max_size: int,
        max_chunk_size: int,
        max_chunk_path_count: int,
        store_reads: bool,
        assemble: bool,
    ) -> None:
        """Components of edges outside bubble chains (reference:
        handleSuperbubbles1, src/AssemblyGraph2.cpp:3198)."""
        self.find_bubble_chains()
        label: Dict[int, int] = {}

        def find(v):
            root = v
            while label.get(root, root) != root:
                root = label[root]
            while label.get(v, v) != root:
                label[v], v = root, label[v]
            return root

        for eid, e in self.edges.items():
            if eid not in self.chain_of_edge:
                ra, rb = find(e.v0), find(e.v1)
                if ra != rb:
                    label[max(ra, rb)] = min(ra, rb)
        comps: Dict[int, List[int]] = {}
        for v in self.vertices():
            comps.setdefault(find(v), []).append(v)
        for root in sorted(comps):
            self._handle_superbubble(
                comps[root], None,
                max_size, max_chunk_size, max_chunk_path_count,
                store_reads, assemble,
            )
        self.clear_bubble_chains()

    def _handle_superbubble(
        self,
        vertices: List[int],
        edge_length_threshold: Optional[int],
        max_size: int,
        max_chunk_size: int,
        max_chunk_path_count: int,
        store_reads: bool,
        assemble: bool,
    ) -> None:
        """Dominator-tree chunked superbubble resolution (reference:
        handleSuperbubble1, src/AssemblyGraph2.cpp:3323): for one
        entrance/one exit, chunk via forward+backward dominator trees;
        non-trivial chunks keep their 2 strongest paths as a new
        bubble; unreachable/unchunked edges are removed."""
        vset = set(vertices)
        # Superbubble edges: (edge id, branch id) with both endpoints
        # inside (+ short, for the handleSuperbubbles0 variant).
        sedges: List[Tuple[int, int]] = []
        for v0 in vertices:
            for eid in self.out_edges(v0):
                e = self.edges[eid]
                if e.v1 not in vset:
                    continue
                if (
                    edge_length_threshold is not None
                    and e.max_path_length() > edge_length_threshold
                ):
                    continue
                for bi in range(e.ploidy):
                    sedges.append((eid, bi))
        if not sedges:
            return

        sedge_set = {eid for eid, _ in sedges}

        # Entrances and exits (reference: Superbubble constructor).
        entrances, exits = [], []
        for v in vertices:
            in_out = any(
                self.edges[eid].v0 not in vset or eid not in sedge_set
                for eid in self.in_edges(v)
                if self.edges[eid].v0 != v
            )
            in_in = any(
                self.edges[eid].v0 in vset and eid in sedge_set
                for eid in self.in_edges(v)
                if self.edges[eid].v0 != v
            )
            out_out = any(
                self.edges[eid].v1 not in vset or eid not in sedge_set
                for eid in self.out_edges(v)
                if self.edges[eid].v1 != v
            )
            out_in = any(
                self.edges[eid].v1 in vset and eid in sedge_set
                for eid in self.out_edges(v)
                if self.edges[eid].v1 != v
            )
            if in_out and out_in:
                entrances.append(v)
            if in_in and out_out:
                exits.append(v)

        # Simple linear chain? Nothing to do.
        if self._is_simple_linear_chain(vertices, sedges):
            return
        if len(entrances) != 1 or len(exits) != 1:
            return
        if len(vertices) > max_size:
            return
        entrance, exit_ = entrances[0], exits[0]

        # Adjacency over superbubble edges.
        out_s: Dict[int, List[Tuple[int, int]]] = {v: [] for v in vertices}
        in_s: Dict[int, List[Tuple[int, int]]] = {v: [] for v in vertices}
        for eid, bi in sedges:
            e = self.edges[eid]
            out_s[e.v0].append((eid, bi))
            in_s[e.v1].append((eid, bi))

        idom_f = _dominator_tree(
            vertices, entrance,
            lambda v: [self.edges[eid].v1 for eid, _ in out_s[v]],
            lambda v: [self.edges[eid].v0 for eid, _ in in_s[v]],
        )
        idom_b = _dominator_tree(
            vertices, exit_,
            lambda v: [self.edges[eid].v0 for eid, _ in in_s[v]],
            lambda v: [self.edges[eid].v1 for eid, _ in out_s[v]],
        )
        if idom_f.get(exit_) is None or idom_b.get(entrance) is None:
            return

        # Critical path (exit -> entrance via forward dominators).
        critical: List[int] = []
        v = exit_
        while True:
            critical.append(v)
            if v == entrance:
                break
            v = idom_f[v]
            if v is None:
                return
        critical.reverse()
        pos_in_critical = {v: i for i, v in enumerate(critical)}

        # Assign edges to chunks (reference: Superbubble::findChunk).
        def chunk_of(eid: int, bi: int) -> Optional[int]:
            e = self.edges[eid]
            v0, v1 = e.v0, e.v1
            while v0 not in pos_in_critical:
                v0 = idom_f.get(v0)
                if v0 is None:
                    return None
            chunk = pos_in_critical[v0]
            while v1 not in pos_in_critical:
                v1 = idom_b.get(v1)
                if v1 is None:
                    return None
            if pos_in_critical[v1] == chunk + 1:
                return chunk
            return None

        chunk_edges: Dict[int, List[Tuple[int, int]]] = {}
        unchunked: List[Tuple[int, int]] = []
        for eid, bi in sedges:
            c = chunk_of(eid, bi)
            if c is None:
                unchunked.append((eid, bi))
            else:
                chunk_edges.setdefault(c, []).append((eid, bi))

        # Remove edges not assigned to any chunk (unreachable).
        for eid, bi in unchunked:
            if bi == 0 and eid in self.edges:
                self.remove_edge(eid)
        removed_from_sb = {eid for eid, bi in unchunked}
        for c in chunk_edges:
            chunk_edges[c] = [
                (eid, bi)
                for eid, bi in chunk_edges[c]
                if eid not in removed_from_sb
            ]

        # Process chunks.
        for chunk_id in range(len(critical) - 1):
            centrance = critical[chunk_id]
            cexit = critical[chunk_id + 1]
            edges_here = chunk_edges.get(chunk_id, [])
            if not edges_here:
                continue
            # Trivial chunk: all out-edges of the chunk entrance go
            # straight to the chunk exit.
            trivial = all(
                self.edges[eid].v1 == cexit
                for eid, bi in out_s[centrance]
                if eid not in removed_from_sb and eid in self.edges
            )
            if trivial:
                continue
            if len(edges_here) > max_chunk_size:
                continue
            for eid, bi in edges_here:
                if eid in self.edges:
                    self.store_read_information_edge(self.edges[eid])

            # Enumerate self-avoiding paths through chunk edges.
            out_chunk: Dict[int, List[Tuple[int, int]]] = {}
            for eid, bi in edges_here:
                if eid in self.edges:
                    out_chunk.setdefault(self.edges[eid].v0, []).append((eid, bi))
            paths: List[List[Tuple[int, int]]] = []

            def dfs(v, visited, acc):
                if len(paths) > max_chunk_path_count:
                    return
                if v == cexit:
                    paths.append(list(acc))
                    return
                for eid, bi in out_chunk.get(v, ()):
                    w = self.edges[eid].v1
                    if w in visited and w != cexit:
                        continue
                    acc.append((eid, bi))
                    visited.add(w)
                    dfs(w, visited, acc)
                    visited.discard(w)
                    acc.pop()

            dfs(centrance, {centrance}, [])
            if len(paths) > max_chunk_path_count or len(paths) < 2:
                continue

            # Two strongest paths by average coverage.
            def path_cov(path):
                cov_sum = sum(
                    self.edges[eid].branches[bi].coverage_sum for eid, bi in path
                )
                len_sum = sum(
                    len(self.edges[eid].branches[bi].path) for eid, bi in path
                )
                return cov_sum / max(len_sum, 1)

            order = sorted(range(len(paths)), key=lambda i: -path_cov(paths[i]))
            best = [paths[order[0]], paths[order[1]]]

            prefix = _common_prefix_length(best[0], best[1])
            suffix = _common_suffix_length(best[0], best[1])

            def mg_path(seq):
                parts = [
                    self.edges[eid].branches[bi].path for eid, bi in seq
                ]
                sec = any(
                    self.edges[eid].branches[bi].contains_secondary
                    for eid, bi in seq
                )
                return (
                    np.concatenate(parts) if parts else np.zeros(0, np.int64)
                ), sec

            if prefix:
                p, sec = mg_path(best[0][:prefix])
                self._add_path_edge(p, sec, store_reads, assemble)
            if (
                prefix + suffix < len(best[0])
                and prefix + suffix < len(best[1])
            ):
                core0 = best[0][prefix : len(best[0]) - suffix]
                core1 = best[1][prefix : len(best[1]) - suffix]
                av0 = self.edges[core0[0][0]].v0
                av1 = self.edges[core0[-1][0]].v1
                p0, s0 = mg_path(core0)
                p1, s1 = mg_path(core1)
                new_id = self.add_edge(
                    av0, av1,
                    [
                        Branch(path=p0, contains_secondary=s0),
                        Branch(path=p1, contains_secondary=s1),
                    ],
                )
                e = self.edges[new_id]
                if store_reads:
                    self.store_read_information_edge(e)
                if assemble:
                    self.assemble_edge(e)
            if suffix:
                p, sec = mg_path(best[0][len(best[0]) - suffix :])
                self._add_path_edge(p, sec, store_reads, assemble)

            # Remove the original chunk edges.
            for eid, bi in edges_here:
                if bi == 0 and eid in self.edges:
                    self.remove_edge(eid)

    def _add_path_edge(
        self, path: np.ndarray, contains_secondary: bool,
        store_reads: bool, assemble: bool,
    ) -> int:
        v0 = int(self.mg.source[path[0]])
        v1 = int(self.mg.target[path[-1]])
        eid = self.add_edge(
            v0, v1, [Branch(path=path, contains_secondary=contains_secondary)]
        )
        e = self.edges[eid]
        if store_reads:
            self.store_read_information_edge(e)
        if assemble:
            self.assemble_edge(e)
        return eid

    def _is_simple_linear_chain(self, vertices, sedges) -> bool:
        if not sedges:
            return True
        eids = {eid for eid, _ in sedges}
        if any(self.edges[eid].is_bubble() for eid in eids):
            return False
        for v in vertices:
            ins = [e for e in self.in_edges(v) if e in eids]
            outs = [e for e in self.out_edges(v) if e in eids]
            if len(ins) > 1 or len(outs) > 1:
                return False
        return True

    # ----- bubble chains + phasing regions -----

    def find_bubble_chains(self) -> None:
        """Linear chains of length >= 2 over ALL edges (reference:
        findBubbleChains, src/AssemblyGraph2.cpp:2889)."""
        self.bubble_chains = []
        self.chain_of_edge = {}
        seen: Set[int] = set()
        for start in sorted(self.edges):
            if start in seen:
                continue
            chain = [start]
            v = self.edges[start].v0
            while self.in_degree(v) == 1 and self.out_degree(v) == 1:
                prev = self.in_edges(v)[0]
                if prev in seen or prev in chain:
                    break
                chain.insert(0, prev)
                v = self.edges[prev].v0
            v = self.edges[start].v1
            while self.in_degree(v) == 1 and self.out_degree(v) == 1:
                nxt = self.out_edges(v)[0]
                if nxt in seen or nxt in chain:
                    break
                chain.append(nxt)
                v = self.edges[nxt].v1
            seen.update(chain)
            if len(chain) >= 2:
                cid = len(self.bubble_chains)
                self.bubble_chains.append(BubbleChain(edges=chain))
                for pos, eid in enumerate(chain):
                    self.chain_of_edge[eid] = (cid, pos)

    def clear_bubble_chains(self) -> None:
        self.bubble_chains = []
        self.chain_of_edge = {}

    def find_phasing_regions(self) -> None:
        """(reference: findPhasingRegions, src/AssemblyGraph2.cpp:2969)"""
        for chain in self.bubble_chains:
            table = [
                (pos, self.edges[eid].component)
                for pos, eid in enumerate(chain.edges)
                if self.edges[eid].component != INVALID
            ]
            chain.phasing_regions = []
            if not table:
                chain.phasing_regions.append(
                    PhasingRegion(0, len(chain.edges) - 1, False)
                )
                continue
            firsts, lasts = [], []
            for i, (pos, comp) in enumerate(table):
                if i == 0 or comp != table[i - 1][1]:
                    firsts.append(pos)
                if i == len(table) - 1 or comp != table[i + 1][1]:
                    lasts.append(pos)
            regions = chain.phasing_regions
            if firsts[0] != 0:
                regions.append(PhasingRegion(0, firsts[0] - 1, False))
            for i in range(len(firsts)):
                comp = self.edges[chain.edges[firsts[i]]].component
                regions.append(PhasingRegion(firsts[i], lasts[i], True, comp))
                if i != len(firsts) - 1 and firsts[i + 1] != lasts[i] + 1:
                    regions.append(
                        PhasingRegion(lasts[i] + 1, firsts[i + 1] - 1, False)
                    )
            if lasts[-1] != len(chain.edges) - 1:
                regions.append(
                    PhasingRegion(lasts[-1] + 1, len(chain.edges) - 1, False)
                )

    # ----- GFA sequence (transfer of common bubble flanks) -----

    def store_gfa_sequence(self) -> None:
        """(reference: countTransferredBases + storeGfaSequence,
        src/AssemblyGraph2.cpp:1858,1943)"""
        self._backward_transfer = {}
        self._forward_transfer = {}
        for eid, e in self.edges.items():
            bt = ft = 0
            if (
                e.is_bubble()
                and self.in_degree(e.v0) == 1
                and self.out_degree(e.v0) == 1
                and self.in_degree(e.v1) == 1
                and self.out_degree(e.v1) == 1
            ):
                prev = self.in_edges(e.v0)[0]
                nxt = self.out_edges(e.v1)[0]
                if (
                    not self.edges[prev].is_bubble()
                    and not self.edges[nxt].is_bubble()
                ):
                    bt = _common_prefix_bases(e.branches)
                    ft = _common_suffix_bases(e.branches)
                    shortest = min(
                        b.raw_sequence.shape[0] for b in e.branches
                    )
                    # Alternate decrements until the transfers fit the
                    # shortest branch (prefix/suffix are each <= the
                    # shortest length, so neither can underflow).
                    while bt + ft > shortest:
                        bt -= 1
                        if bt + ft <= shortest:
                            break
                        ft -= 1
            self._backward_transfer[eid] = bt
            self._forward_transfer[eid] = ft

        for eid, e in self.edges.items():
            bt = self._backward_transfer[eid]
            ft = self._forward_transfer[eid]
            for b in e.branches:
                parts = []
                if not e.is_bubble():
                    if self.in_degree(e.v0) == 1 and self.out_degree(e.v0) == 1:
                        prev = self.in_edges(e.v0)[0]
                        pe = self.edges[prev]
                        if pe.is_bubble():
                            f = self._forward_transfer[prev]
                            if f:
                                parts.append(
                                    pe.branches[0].raw_sequence[-f:]
                                )
                s = b.raw_sequence
                parts.append(s[bt : s.shape[0] - ft])
                if not e.is_bubble():
                    if self.in_degree(e.v1) == 1 and self.out_degree(e.v1) == 1:
                        nxt = self.out_edges(e.v1)[0]
                        ne = self.edges[nxt]
                        if ne.is_bubble():
                            bck = self._backward_transfer[nxt]
                            if bck:
                                parts.append(
                                    ne.branches[0].raw_sequence[:bck]
                                )
                b.gfa_sequence = (
                    np.concatenate(parts) if parts else np.zeros(0, np.uint8)
                )

    # ----- statistics -----

    def het_snp_statistics(self) -> Tuple[int, int, int]:
        """(transitions, transversions, non-SNP small bubbles)
        (reference: hetSnpStatistics, src/AssemblyGraph2.cpp:2476)."""
        transitions = transversions = non_snp = 0
        for e in self.edges.values():
            if e.ploidy != 2:
                continue
            s0 = e.branches[0].gfa_sequence
            s1 = e.branches[1].gfa_sequence
            if s0 is None or s1 is None:
                continue
            if s0.shape[0] != 1 or s1.shape[0] != 1:
                non_snp += 1
                continue
            # A/G are purines (codes 0, 2); C/T pyrimidines (1, 3).
            if (int(s0[0]) % 2) == (int(s1[0]) % 2):
                transitions += 1
            else:
                transversions += 1
        return transitions, transversions, non_snp


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _dominator_tree(vertices, root, succ, pred):
    """Immediate dominators via the Cooper-Harvey-Kennedy iterative
    algorithm (the reference uses Lengauer-Tarjan; superbubbles are
    tiny so the simple fixpoint is fine). Returns {v: idom} with
    root -> root; unreachable vertices are absent."""
    # Reverse postorder from root.
    order: List[int] = []
    seen = {root}
    stack = [(root, iter(succ(root)))]
    while stack:
        v, it = stack[-1]
        advanced = False
        for w in it:
            if w not in seen:
                seen.add(w)
                stack.append((w, iter(succ(w))))
                advanced = True
                break
        if not advanced:
            order.append(v)
            stack.pop()
    order.reverse()  # reverse postorder
    rpo = {v: i for i, v in enumerate(order)}

    idom = {root: root}
    changed = True
    while changed:
        changed = False
        for v in order:
            if v == root:
                continue
            new_idom = None
            for p in pred(v):
                if p in idom:
                    if new_idom is None:
                        new_idom = p
                    else:
                        # intersect
                        a, b = p, new_idom
                        while a != b:
                            while rpo[a] > rpo[b]:
                                a = idom[a]
                            while rpo[b] > rpo[a]:
                                b = idom[b]
                        new_idom = a
            if new_idom is not None and idom.get(v) != new_idom:
                idom[v] = new_idom
                changed = True
    return idom


def _common_prefix_length(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _common_suffix_length(a, b) -> int:
    n = 0
    for x, y in zip(reversed(a), reversed(b)):
        if x != y:
            break
        n += 1
    return n


def _common_prefix_bases(branches: List[Branch]) -> int:
    s0 = branches[0].raw_sequence
    for pos in range(s0.shape[0]):
        for b in branches[1:]:
            s = b.raw_sequence
            if pos == s.shape[0] or s[pos] != s0[pos]:
                return pos
    return s0.shape[0]


def _common_suffix_bases(branches: List[Branch]) -> int:
    s0 = branches[0].raw_sequence
    for pos in range(s0.shape[0]):
        for b in branches[1:]:
            s = b.raw_sequence
            if pos == s.shape[0] or s[s.shape[0] - 1 - pos] != s0[s0.shape[0] - 1 - pos]:
                return pos
    return s0.shape[0]


# ---------------------------------------------------------------------------
# Orchestration (the reference constructor sequence)
# ---------------------------------------------------------------------------


@dataclass
class Mode2Parameters:
    """Mirrors Mode2AssemblyOptions defaults (reference:
    src/AssemblerOptions.cpp Assembly.mode2.* section)."""

    prune_length: int = 0
    strong_branch_threshold: int = 2
    epsilon: float = 0.1
    bubble_removal_min_concordant: int = 3
    bubble_removal_max_discordant: int = 6
    bubble_removal_min_log_p: float = 30.0
    bubble_removal_component_size_threshold: int = 10
    phasing_min_concordant: int = 2
    phasing_max_discordant: int = 1
    phasing_min_log_p: float = 10.0
    superbubble_max_size: int = 50
    superbubble_max_chunk_size: int = 20
    superbubble_max_chunk_path_count: int = 20
    superbubble_edge_length_threshold: int = 6
    suppress_gfa_output: bool = False
    suppress_fasta_output: bool = False
    suppress_detailed_output: bool = False
    suppress_phased_output: bool = False
    suppress_haploid_output: bool = False


def remove_bad_bubbles_iterative(g: AssemblyGraph2, p: Mode2Parameters) -> int:
    """(reference: removeBadBubblesIterative,
    src/AssemblyGraph2.cpp:4294): small phasing components indicate
    bubbles not consistently phaseable; squash them to their strongest
    branch and repeat until stable."""
    from shasta_tpu_torch.graph.phasing import PhasingGraph

    total_removed = 0
    while True:
        # Each diploid bubble its own component.
        cid = 0
        for eid in sorted(g.edges):
            e = g.edges[eid]
            if e.ploidy == 2:
                e.component = cid
                e.phase = 0
                cid += 1
            else:
                e.component = INVALID
                e.phase = INVALID
        pg = PhasingGraph(
            g,
            p.bubble_removal_min_concordant,
            p.bubble_removal_max_discordant,
            p.bubble_removal_min_log_p,
            p.epsilon,
            allow_random_hypothesis=True,
        )
        pg.compute_spanning_tree()
        pg.phase()

        # Vertices in small phasing components, one bincount pass.
        n_v = pg.vertex_count
        comp = np.asarray(pg.component_v[:n_v], np.int64)
        valid = comp != INVALID
        sizes = np.bincount(comp[valid]) if valid.any() else np.zeros(1)
        small = np.zeros(n_v, bool)
        small[valid] = (
            sizes[comp[valid]] < p.bubble_removal_component_size_threshold
        )
        n_invalid = int((~valid).sum())
        small[~valid] = n_invalid < p.bubble_removal_component_size_threshold
        bad = np.flatnonzero(small)
        if bad.shape[0] == 0:
            break
        for vi in bad:
            for eid, _phase in pg.bubbles[vi]:
                if eid in g.edges:
                    e = g.edges[eid]
                    strongest = e.strongest_branch_id()
                    e.branches = [e.branches[strongest]]
        total_removed += len(bad)
        g.merge(True, True)
        g.gather_bubbles()
        g.force_maximum_ploidy(2)
        g.handle_superbubbles0(
            p.superbubble_edge_length_threshold,
            p.superbubble_max_size,
            p.superbubble_max_chunk_size,
            p.superbubble_max_chunk_path_count,
            True,
            True,
        )
        g.merge(True, True)
        g.handle_superbubbles1(
            p.superbubble_max_size,
            p.superbubble_max_chunk_size,
            p.superbubble_max_chunk_path_count,
            True,
            True,
        )
        g.merge(True, True)
        g.prune(p.prune_length)
    return total_removed


def hierarchical_phase(g: AssemblyGraph2, p: Mode2Parameters) -> int:
    """(reference: hierarchicalPhase, src/AssemblyGraph2.cpp:4460):
    iterate the PhasingGraph, merging phasing components until no
    edges survive the criteria. Returns iteration count."""
    from shasta_tpu_torch.graph.phasing import PhasingGraph

    cid = 0
    for eid in sorted(g.edges):
        e = g.edges[eid]
        if e.ploidy == 2:
            e.component = cid
            e.phase = 0
            cid += 1
        else:
            e.component = INVALID
            e.phase = INVALID
    iterations = 0
    while True:
        pg = PhasingGraph(
            g,
            p.phasing_min_concordant,
            p.phasing_max_discordant,
            p.phasing_min_log_p,
            p.epsilon,
            allow_random_hypothesis=False,
        )
        pg.compute_spanning_tree()
        if pg.edge_count == 0:
            break
        pg.phase()
        pg.store_phasing(g)
        iterations += 1
    return iterations


def run_assembly_graph2(
    g: AssemblyGraph2,
    p: Mode2Parameters,
) -> Dict[str, int]:
    """The full reference constructor sequence
    (reference: src/AssemblyGraph2.cpp:44-233). The graph must have an
    assembler installed (set_assembler) before calling."""
    g.create()
    g.prune(p.prune_length)
    g.remove_short_loopback_edges(p.superbubble_edge_length_threshold)
    g.gather_bubbles()
    g.handle_superbubbles0(
        p.superbubble_edge_length_threshold,
        p.superbubble_max_size,
        p.superbubble_max_chunk_size,
        p.superbubble_max_chunk_path_count,
        False,
        False,
    )
    g.merge(False, False)
    g.handle_superbubbles1(
        p.superbubble_max_size,
        p.superbubble_max_chunk_size,
        p.superbubble_max_chunk_path_count,
        False,
        False,
    )
    g.merge(False, False)
    g.store_read_information()
    g.remove_weak_branches(p.strong_branch_threshold)
    g.merge(True, False)
    g.gather_bubbles()
    g.force_maximum_ploidy(2)
    g.assemble_all()
    g.remove_degenerate_branches()
    g.merge(True, True)
    g.prune(p.prune_length)
    n_bad = remove_bad_bubbles_iterative(g, p)
    hierarchical_phase(g, p)
    g.prune(p.prune_length)
    g.find_bubble_chains()
    g.find_phasing_regions()
    g.store_gfa_sequence()
    transitions, transversions, non_snp = g.het_snp_statistics()
    diploid = sum(1 for e in g.edges.values() if e.ploidy == 2)
    phased = sum(
        1 for e in g.edges.values() if e.ploidy == 2 and e.is_phased()
    )
    components = {
        e.component for e in g.edges.values() if e.component != INVALID
    }
    return {
        "badBubblesRemoved": n_bad,
        "diploidBubbleCount": diploid,
        "phasedBubbleCount": phased,
        "phasedComponentCount": len(components),
        "bubbleChainCount": len(g.bubble_chains),
        "hetSnpTransitionCount": transitions,
        "hetSnpTransversionCount": transversions,
        "nonSnpSmallBubbleCount": non_snp,
    }


# ---------------------------------------------------------------------------
# Output writers (the Detailed/Haploid/Phased file family)
# ---------------------------------------------------------------------------

from shasta_tpu_torch.graph.assembly_graph import _seq_str  # byte-LUT writer


def _write_gfa(path: str, segments, links, with_sequence: bool) -> None:
    """segments: list of (name, v0, v1, seq or length)."""
    with open(path, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        for name, _v0, _v1, seq in segments:
            if with_sequence:
                f.write(f"S\t{name}\t{_seq_str(seq)}\tLN:i:{seq.shape[0]}\n")
            else:
                n = seq if isinstance(seq, int) else seq.shape[0]
                f.write(f"S\t{name}\t*\tLN:i:{n}\n")
        for a, b in links:
            f.write(f"L\t{a}\t+\t{b}\t+\t0M\n")


def _segment_links(segments) -> List[Tuple[str, str]]:
    by_source: Dict[int, List[str]] = {}
    for name, v0, _v1, _s in segments:
        by_source.setdefault(v0, []).append(name)
    links = []
    for name, _v0, v1, _s in segments:
        for other in by_source.get(v1, ()):
            links.append((name, other))
    return links


def _edge_color(e: AG2Edge, branch_id: int) -> str:
    """(reference: AssemblyGraph2Edge::color)"""
    if e.is_bubble():
        if e.phase == INVALID:
            return "#808080" if branch_id == e.strongest_branch_id() else "#C0C0C0"
        return "#bf4040" if branch_id == e.phase else "#4040bf"
    return "#808080"


def write_detailed(
    g: AssemblyGraph2,
    base: str,
    with_sequence: bool,
    write_gfa: bool = True,
    write_fasta: bool = True,
    write_csv: bool = True,
) -> None:
    """(reference: writeDetailed, src/AssemblyGraph2.cpp:960): one
    segment per branch of every edge."""
    segments = []
    for eid in sorted(g.edges):
        e = g.edges[eid]
        for bi, b in enumerate(e.branches):
            seq = b.gfa_sequence if b.gfa_sequence is not None else np.zeros(0, np.uint8)
            segments.append((e.path_id(bi), e.v0, e.v1, seq))
    if write_gfa:
        _write_gfa(base + ".gfa", segments, _segment_links(segments), with_sequence)
    if write_fasta and with_sequence:
        with open(base + ".fasta", "w") as f:
            for name, _v0, _v1, seq in segments:
                f.write(f">{name} {seq.shape[0]}\n{_seq_str(seq)}\n")
    if write_csv:
        with open(base + ".csv", "w") as f:
            f.write(
                "Name,Component,Phase,Color,First marker graph edge,"
                "Last marker graph edge,Secondary,Minimum edge coverage,"
                "Average edge coverage,Number of distinct oriented reads\n"
            )
            for eid in sorted(g.edges):
                e = g.edges[eid]
                for bi, b in enumerate(e.branches):
                    comp = e.component if e.component != INVALID else ""
                    phase = (
                        (0 if bi == e.phase else 1) if e.phase != INVALID else ""
                    )
                    f.write(
                        f"{e.path_id(bi)},{comp},{phase},"
                        f"{_edge_color(e, bi)},"
                        f"{b.path[0] if len(b.path) else ''},"
                        f"{b.path[-1] if len(b.path) else ''},"
                        f"{'S' if b.contains_secondary else ''},"
                        f"{b.minimum_coverage},{b.average_coverage()},"
                        f"{b.reads.shape[0] if b.reads is not None else 0}\n"
                    )


def write_haploid(
    g: AssemblyGraph2,
    base: str,
    with_sequence: bool,
    write_gfa: bool = True,
    write_fasta: bool = True,
    write_csv: bool = True,
) -> Dict[str, int]:
    """(reference: writeHaploid, src/AssemblyGraph2.cpp:1192): one
    segment per bubble chain (strongest branch at each bubble), plus
    segments for edges outside bubble chains."""
    segments = []
    chain_lengths = []
    for eid in sorted(g.edges):
        if eid in g.chain_of_edge:
            continue
        e = g.edges[eid]
        for bi, b in enumerate(e.branches):
            seq = b.gfa_sequence if b.gfa_sequence is not None else np.zeros(0, np.uint8)
            segments.append((e.path_id(bi), e.v0, e.v1, seq))
    for cid, chain in enumerate(g.bubble_chains):
        parts = []
        for eid in chain.edges:
            e = g.edges[eid]
            b = e.branches[e.strongest_branch_id()]
            if b.gfa_sequence is not None:
                parts.append(b.gfa_sequence)
        seq = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        chain_lengths.append(seq.shape[0])
        v0 = g.edges[chain.edges[0]].v0
        v1 = g.edges[chain.edges[-1]].v1
        segments.append((f"BC.{cid}", v0, v1, seq))
    if write_gfa:
        _write_gfa(base + ".gfa", segments, _segment_links(segments), with_sequence)
    if write_fasta and with_sequence:
        with open(base + ".fasta", "w") as f:
            for name, _v0, _v1, seq in segments:
                f.write(f">{name} {seq.shape[0]}\n{_seq_str(seq)}\n")
    if write_csv:
        with open(base + ".csv", "w") as f:
            f.write("Name,Color\n")
            for name, _v0, _v1, _s in segments:
                color = "Cyan" if name.startswith("BC.") else "#808080"
                f.write(f"{name},{color}\n")
    total = int(sum(chain_lengths))
    n50 = _n50(chain_lengths, total)
    return {"totalBubbleChainLength": total, "bubbleChainN50": n50}


def write_phased(
    g: AssemblyGraph2,
    base: str,
    with_sequence: bool,
    write_gfa: bool = True,
    write_fasta: bool = True,
    write_csv: bool = True,
) -> Dict[str, int]:
    """(reference: writePhased, src/AssemblyGraph2.cpp:1360): phased
    regions produce two haplotype segments PR.<chain>.<region>.<comp>.<h>;
    unphased regions one UR.<chain>.<region> segment."""
    segments = []
    csv_rows = []
    haploid_lengths: List[int] = []
    diploid_lengths: List[int] = []
    outside = 0
    for eid in sorted(g.edges):
        if eid in g.chain_of_edge:
            continue
        e = g.edges[eid]
        for bi, b in enumerate(e.branches):
            seq = b.gfa_sequence if b.gfa_sequence is not None else np.zeros(0, np.uint8)
            name = e.path_id(bi)
            segments.append((name, e.v0, e.v1, seq))
            csv_rows.append(f"{name},,,,,,{seq.shape[0]},#808080")
            outside += seq.shape[0]

    def region_sequence(chain, region, haplotype=None):
        parts = []
        for pos in range(region.first_position, region.last_position + 1):
            e = g.edges[chain.edges[pos]]
            if haplotype is None or e.component == INVALID:
                b = e.branches[e.strongest_branch_id()]
            else:
                bi = 0 if e.phase == haplotype else 1
                b = e.branches[bi]
            if b.gfa_sequence is not None:
                parts.append(b.gfa_sequence)
        return np.concatenate(parts) if parts else np.zeros(0, np.uint8)

    for cid, chain in enumerate(g.bubble_chains):
        for rid, region in enumerate(chain.phasing_regions):
            v0 = g.edges[chain.edges[region.first_position]].v0
            v1 = g.edges[chain.edges[region.last_position]].v1
            if region.is_phased:
                for h in (0, 1):
                    name = f"PR.{cid}.{rid}.{region.component}.{h}"
                    seq = region_sequence(chain, region, h)
                    segments.append((name, v0, v1, seq))
                    diploid_lengths.append(seq.shape[0])
                    csv_rows.append(
                        f"{name},{rid},2,{cid},{region.component},{h},"
                        f"{seq.shape[0]},Green"
                    )
            else:
                name = f"UR.{cid}.{rid}"
                seq = region_sequence(chain, region)
                segments.append((name, v0, v1, seq))
                haploid_lengths.append(seq.shape[0])
                csv_rows.append(
                    f"{name},{rid},1,{cid},,,{seq.shape[0]},#eb4034"
                )
    if write_gfa:
        _write_gfa(base + ".gfa", segments, _segment_links(segments), with_sequence)
    if write_fasta and with_sequence:
        with open(base + ".fasta", "w") as f:
            for name, _v0, _v1, seq in segments:
                f.write(f">{name} {seq.shape[0]}\n{_seq_str(seq)}\n")
    if write_csv:
        with open(base + ".csv", "w") as f:
            f.write(
                "Name,Position in bubble chain,Ploidy,Bubble chain,"
                "Component,Haplotype,Length,Color\n"
            )
            for row in csv_rows:
                f.write(row + "\n")
    total_diploid = int(sum(diploid_lengths))
    total_haploid = int(sum(haploid_lengths))
    return {
        "totalDiploidLengthBothHaplotypes": total_diploid,
        "diploidN50": _n50(diploid_lengths, total_diploid),
        "totalHaploidLength": total_haploid,
        "haploidN50": _n50(haploid_lengths, total_haploid),
        "outsideBubbleChainsLength": int(outside),
    }


def write_phased_details(g: AssemblyGraph2, path: str) -> None:
    """Relate coordinates in the phased assembly to coordinates in the
    detailed assembly (reference: writePhasedDetails,
    src/AssemblyGraph2.cpp:1620): one row per detailed segment
    contributing to each PR.<chain>.<region>.<comp>.<h> / UR.<chain>.<region>
    phased-assembly segment, with its begin/end offsets."""
    with open(path, "w") as f:
        f.write("Segment,Detailed segment,Length,Begin,End\n")
        for cid, chain in enumerate(g.bubble_chains):
            for rid, region in enumerate(chain.phasing_regions):
                if region.is_phased:
                    for h in (0, 1):
                        name = f"PR.{cid}.{rid}.{region.component}.{h}"
                        n = 0
                        for pos in range(
                            region.first_position, region.last_position + 1
                        ):
                            e = g.edges[chain.edges[pos]]
                            if e.component == INVALID:
                                bi = e.strongest_branch_id()
                            else:
                                bi = 0 if e.phase == h else 1
                            b = e.branches[bi]
                            length = (
                                b.gfa_sequence.shape[0]
                                if b.gfa_sequence is not None
                                else 0
                            )
                            f.write(
                                f"{name},{e.path_id(bi)},{length},{n},"
                                f"{n + length}\n"
                            )
                            n += length
                else:
                    name = f"UR.{cid}.{rid}"
                    n = 0
                    for pos in range(
                        region.first_position, region.last_position + 1
                    ):
                        e = g.edges[chain.edges[pos]]
                        b = e.branches[e.strongest_branch_id()]
                        length = (
                            b.gfa_sequence.shape[0]
                            if b.gfa_sequence is not None
                            else 0
                        )
                        f.write(
                            f"{name},{e.path_id(0)},{length},{n},{n + length}\n"
                        )
                        n += length


def write_phasing_regions(g: AssemblyGraph2, path: str) -> None:
    """(reference: writePhasingRegions, src/AssemblyGraph2.cpp:3065)"""
    with open(path, "w") as f:
        f.write(
            "BubbleChainId,PhasingRegionId,FirstPosition,LastPosition,"
            "IsPhased,ComponentId\n"
        )
        for cid, chain in enumerate(g.bubble_chains):
            for rid, r in enumerate(chain.phasing_regions):
                comp = r.component if r.is_phased else ""
                f.write(
                    f"{cid},{rid},{r.first_position},{r.last_position},"
                    f"{'Yes' if r.is_phased else 'No'},{comp}\n"
                )


def write_bubble_chains_csv(g: AssemblyGraph2, path: str) -> None:
    """(reference: writeBubbleChains, src/AssemblyGraph2.cpp:3095)"""
    with open(path, "w") as f:
        f.write("BubbleChainId,Position,EdgeId,Ploidy,Component,Phase\n")
        for cid, chain in enumerate(g.bubble_chains):
            for pos, eid in enumerate(chain.edges):
                e = g.edges[eid]
                comp = e.component if e.component != INVALID else ""
                ph = e.phase if e.phase != INVALID else ""
                f.write(f"{cid},{pos},{eid},{e.ploidy},{comp},{ph}\n")


def _n50(lengths, total) -> int:
    if total <= 0:
        return 0
    s = sorted(lengths, reverse=True)
    cum = 0
    for x in s:
        cum += x
        if cum >= total / 2:
            return int(x)
    return 0
