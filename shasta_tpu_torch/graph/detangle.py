"""Assembly graph detangling (methods 1 and 2).

Counterpart of the reference AssemblyPathGraph2
(reference: src/AssemblyPathGraph2.{hpp,cpp}, driven by
Assembler::detangle2 at src/AssemblerDetangle.cpp:310). A tangle is an
edge v0->v1 with in(v0)>1, out(v0)=1, in(v1)=1, out(v1)>1 and no
out-edge of v1 that is also an in-edge of v0. The tangle matrix counts
oriented reads shared between each in-edge and out-edge; a tangle is
solvable when the row-wise argmax defines a permutation whose diagonal
dominates rows and columns and passes the read-count thresholds
(findIfSolvable, src/AssemblyPathGraph2.cpp:965-1115). Solvable
tangles are processed in decreasing priority (the smallest diagonal
element); each detangle replaces the in/tangle/out edges with one
merged path per matched pair, duplicating the tangle edge
(Pevzner-style).

Simplification vs the reference: complementary tangle pairs whose
edges collide (a tangle sharing edges with its own reverse complement,
detangleCollidingComplementaryPair) are treated as unsolvable instead
of getting the special 3-way merge; these are rare self-complementary
regions.

The result is applied by rebuilding the assembly graph with the
detangled paths as edge chains (marker-graph edges may then appear in
more than one chain, as in the reference's rebuilt assembly graph).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph
from shasta_tpu_torch.graph.marker_graph import MarkerGraph


@dataclass
class _PEdge:
    src: int  # assembly vertex index (marker graph vertex id)
    tgt: int
    path: List[int]  # assembly graph edge ids
    path_length: int  # marker graph edges on the path
    orients: np.ndarray  # sorted oriented read ids
    rc: int = -1  # rc edge id


class _PathGraph:
    def __init__(self):
        self.edges: Dict[int, _PEdge] = {}
        self.next_id = 0
        self.out_of: Dict[int, Set[int]] = {}
        self.in_of: Dict[int, Set[int]] = {}

    def add_edge(self, e: _PEdge) -> int:
        eid = self.next_id
        self.next_id += 1
        self.edges[eid] = e
        self.out_of.setdefault(e.src, set()).add(eid)
        self.in_of.setdefault(e.tgt, set()).add(eid)
        return eid

    def remove_edge(self, eid: int) -> None:
        e = self.edges.pop(eid)
        self.out_of[e.src].discard(eid)
        self.in_of[e.tgt].discard(eid)

    def out_edges(self, v: int) -> List[int]:
        return sorted(self.out_of.get(v, ()))

    def in_edges(self, v: int) -> List[int]:
        return sorted(self.in_of.get(v, ()))


def _edge_oriented_reads(ag: AssemblyGraph, mg: MarkerGraph, e: int) -> np.ndarray:
    chain = ag.chain(e)
    parts = []
    for me in chain:
        lo, hi = mg.interval_offsets[me], mg.interval_offsets[me + 1]
        parts.append(mg.interval_orid[lo:hi])
    if not parts:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(parts))


def _find_tangle(g: _PathGraph, eid: int) -> Optional[Tuple[List[int], List[int]]]:
    e = g.edges[eid]
    v0, v1 = e.src, e.tgt
    if v0 == v1:
        return None
    ins = g.in_edges(v0)
    outs = g.out_edges(v1)
    if len(ins) <= 1 or len(outs) <= 1:
        return None
    if len(g.out_edges(v0)) != 1 or len(g.in_edges(v1)) != 1:
        return None
    # No out-edge of v1 may also be an in-edge of v0 (reverse bubble).
    if set(outs) & set(ins):
        return None
    # The tangle edge itself cannot be among them.
    if eid in ins or eid in outs:
        return None
    return ins, outs


def _solve_tangle(
    g: _PathGraph,
    ins: List[int],
    outs: List[int],
    diagonal_read_count_min: int,
    off_diagonal_read_count_max: int,
    off_diagonal_ratio: float,
) -> Optional[Tuple[List[int], int]]:
    """Returns (match, priority) if solvable (reference: findIfSolvable)."""
    n = len(ins)
    if len(outs) != n:
        return None
    M = np.zeros((n, n), dtype=np.int64)
    for i, ei in enumerate(ins):
        oi = g.edges[ei].orients
        for j, ej in enumerate(outs):
            M[i, j] = np.intersect1d(oi, g.edges[ej].orients).shape[0]
    match = [int(np.argmax(M[i])) for i in range(n)]
    # Diagonal must strictly dominate rows and columns.
    for i in range(n):
        j = match[i]
        if (M[:, j] >= M[i, j]).sum() > 1 or (M[i, :] >= M[i, j]).sum() > 1:
            return None
    if sorted(match) != list(range(n)):
        return None
    inverse = [0] * n
    for i, j in enumerate(match):
        inverse[j] = i
    for i in range(n):
        for j in range(n):
            if j == match[i]:
                if M[i, j] < diagonal_read_count_min:
                    return None
            elif M[i, j] > off_diagonal_read_count_max:
                if M[i, j] / M[i, match[i]] > off_diagonal_ratio:
                    return None
                if M[i, j] / M[inverse[j], j] > off_diagonal_ratio:
                    return None
    priority = int(min(M[i, match[i]] for i in range(n)))
    return match, priority


def _solve_tangle_method1(
    g: _PathGraph,
    ins: List[int],
    outs: List[int],
) -> Optional[Tuple[List[int], int]]:
    """Method-1 solvability (reference: Tangle::findIfSolvable,
    src/AssemblyPathGraph.cpp): the tangle matrix must be square and a
    permutation by support — every row and every column has EXACTLY one
    nonzero element. Stricter than method 2: any stray shared read
    makes the tangle unsolvable instead of being tolerated as
    off-diagonal noise. Priority is the smallest nonzero element
    (reference: Tangle::computePriority)."""
    n = len(ins)
    if len(outs) != n:
        return None
    M = np.zeros((n, n), dtype=np.int64)
    for i, ei in enumerate(ins):
        oi = g.edges[ei].orients
        for j, ej in enumerate(outs):
            M[i, j] = np.intersect1d(oi, g.edges[ej].orients).shape[0]
    nz = M != 0
    if not ((nz.sum(axis=1) == 1).all() and (nz.sum(axis=0) == 1).all()):
        return None
    match = [int(np.argmax(nz[i])) for i in range(n)]
    priority = int(M[nz].min())
    return match, priority


def detangle_assembly_graph(
    ag: AssemblyGraph,
    mg: MarkerGraph,
    diagonal_read_count_min: int = 6,
    off_diagonal_read_count_max: int = 2,
    off_diagonal_ratio: float = 0.3,
    max_iterations: int = 10000,
    method: int = 2,
) -> AssemblyGraph:
    """Detangle and rebuild; returns the new assembly graph.

    ``method`` selects the solvability criterion: 1 = exact permutation
    by read support (reference: AssemblyPathGraph), 2 = dominant
    diagonal with off-diagonal tolerances (reference:
    AssemblyPathGraph2)."""
    g = _PathGraph()
    n_e = ag.edge_count
    ids = []
    for e in range(n_e):
        pe = _PEdge(
            src=int(ag.source_v[e]),
            tgt=int(ag.target_v[e]),
            path=[e],
            path_length=int(ag.chain_offsets[e + 1] - ag.chain_offsets[e]),
            orients=_edge_oriented_reads(ag, mg, e),
        )
        ids.append(g.add_edge(pe))
    for e in range(n_e):
        g.edges[ids[e]].rc = ids[int(ag.rc_edge[e])]

    skip: Set[int] = set()
    for _ in range(max_iterations):
        # Find the best solvable tangle.
        best = None
        for eid in list(g.edges):
            if eid in skip:
                continue
            t = _find_tangle(g, eid)
            if t is None:
                continue
            if method == 1:
                sol = _solve_tangle_method1(g, t[0], t[1])
            else:
                sol = _solve_tangle(
                    g,
                    t[0],
                    t[1],
                    diagonal_read_count_min,
                    off_diagonal_read_count_max,
                    off_diagonal_ratio,
                )
            if sol is None:
                continue
            match, priority = sol
            if best is None or priority > best[0]:
                best = (priority, eid, t[0], t[1], match)
        if best is None:
            break
        _, eid, ins, outs, match = best

        # Locate the reverse complement tangle.
        rc_eid = g.edges[eid].rc
        involved = set(ins) | set(outs) | {eid}
        if rc_eid == eid or rc_eid not in g.edges:
            # Self-complementary tangle edge: leave it alone
            # (the reference marks these unsolvable).
            skip.add(eid)
            continue
        rc_t = _find_tangle(g, rc_eid)
        if rc_t is None:
            skip.add(eid)
            continue
        if method == 1:
            rc_sol = _solve_tangle_method1(g, rc_t[0], rc_t[1])
        else:
            rc_sol = _solve_tangle(
                g,
                rc_t[0],
                rc_t[1],
                diagonal_read_count_min,
                off_diagonal_read_count_max,
                off_diagonal_ratio,
            )
        rc_involved = set(rc_t[0]) | set(rc_t[1]) | {rc_eid}

        if rc_eid in involved or involved & rc_involved:
            # Colliding complementary pair: the two tangles share
            # edges and must be detangled together with a 3-way merge
            # (reference: detangleCollidingComplementaryPair,
            # src/AssemblyPathGraph2.cpp:607-800).
            if rc_sol is None:
                skip.add(eid)
                continue
            new_ids = _apply_detangle_colliding(
                g, eid, ins, outs, match, rc_eid, rc_t[0], rc_t[1], rc_sol[0]
            )
            if new_ids is None:
                # Unusual arrangement (tangles follow each other both
                # ways, or neither): unsolvable
                # (reference: AssemblyPathGraph2.cpp:640-670).
                skip.add(eid)
                continue
            _fix_rc(g, ag, new_ids)
            continue

        new_a = _apply_detangle(g, eid, ins, outs, match)
        if rc_sol is not None:
            new_b = _apply_detangle(g, rc_eid, rc_t[0], rc_t[1], rc_sol[0])
        else:
            new_b = []
        # Fix rc pointers among new edges by path matching.
        _fix_rc(g, ag, new_a + new_b)

    # Rebuild the assembly graph from the path graph edges.
    return _rebuild(g, ag, mg)


def _apply_detangle(
    g: _PathGraph, eid: int, ins: List[int], outs: List[int], match: List[int]
) -> List[int]:
    tangle = g.edges[eid]
    new_ids = []
    for i, ei in enumerate(ins):
        ein = g.edges[ei]
        eout = g.edges[outs[match[i]]]
        merged = _PEdge(
            src=ein.src,
            tgt=eout.tgt,
            path=ein.path + tangle.path + eout.path,
            path_length=ein.path_length + tangle.path_length + eout.path_length,
            # Reads of the tangle edge are intentionally excluded
            # (reference: src/AssemblyPathGraph2.cpp:503-506).
            orients=np.union1d(ein.orients, eout.orients),
        )
        new_ids.append(g.add_edge(merged))
    for e in ins + outs + [eid]:
        if e in g.edges:
            g.remove_edge(e)
    return new_ids


def _apply_detangle_colliding(
    g: _PathGraph,
    eid_a: int,
    ins_a: List[int],
    outs_a: List[int],
    match_a: List[int],
    eid_b: int,
    ins_b: List[int],
    outs_b: List[int],
    match_b: List[int],
) -> Optional[List[int]]:
    """Detangle a colliding complementary tangle pair: one tangle's
    out-edges are the other's in-edges, so each matched triplet
    (inEdge, middleEdge, outEdge) merges into one edge spanning both
    tangle edges (reference: detangleCollidingComplementaryPair,
    src/AssemblyPathGraph2.cpp:607-800). Returns None for the unusual
    arrangements the reference marks unsolvable."""
    b_follows_a = sorted(outs_a) == sorted(ins_b)
    a_follows_b = sorted(ins_a) == sorted(outs_b)
    if b_follows_a == a_follows_b:  # both or neither
        return None
    if b_follows_a:
        t0, ins0, outs0, m0 = eid_a, ins_a, outs_a, match_a
        t1, ins1, outs1, m1 = eid_b, ins_b, outs_b, match_b
    else:
        t0, ins0, outs0, m0 = eid_b, ins_b, outs_b, match_b
        t1, ins1, outs1, m1 = eid_a, ins_a, outs_a, match_a

    e0 = g.edges[t0]
    e1 = g.edges[t1]
    new_ids = []
    for i, ein_id in enumerate(ins0):
        mid_id = outs0[m0[i]]
        j1 = ins1.index(mid_id)
        out_id = outs1[m1[j1]]
        ein = g.edges[ein_id]
        mid = g.edges[mid_id]
        eout = g.edges[out_id]
        merged = _PEdge(
            src=ein.src,
            tgt=eout.tgt,
            path=ein.path + e0.path + mid.path + e1.path + eout.path,
            path_length=(
                ein.path_length + e0.path_length + mid.path_length
                + e1.path_length + eout.path_length
            ),
            # Reads of both tangle edges are excluded
            # (reference: AssemblyPathGraph2.cpp:739-745).
            orients=np.union1d(np.union1d(ein.orients, mid.orients), eout.orients),
        )
        new_ids.append(g.add_edge(merged))
    for e in set(ins0) | set(outs0) | set(outs1) | {t0, t1}:
        if e in g.edges:
            g.remove_edge(e)
    return new_ids


def _fix_rc(g: _PathGraph, ag: AssemblyGraph, new_ids: List[int]) -> None:
    by_path = {tuple(g.edges[e].path): e for e in new_ids}
    for e in new_ids:
        rc_path = tuple(int(ag.rc_edge[x]) for x in reversed(g.edges[e].path))
        rc = by_path.get(rc_path, -1)
        g.edges[e].rc = rc


def _rebuild(g: _PathGraph, ag: AssemblyGraph, mg: MarkerGraph) -> AssemblyGraph:
    eids = sorted(g.edges)
    chains: List[np.ndarray] = []
    src_v = []
    tgt_v = []
    for eid in eids:
        pe = g.edges[eid]
        chain = np.concatenate([ag.chain(x) for x in pe.path])
        chains.append(chain)
        src_v.append(pe.src)
        tgt_v.append(pe.tgt)

    n = len(eids)
    chain_offsets = np.zeros(n + 1, dtype=np.int64)
    for i, c in enumerate(chains):
        chain_offsets[i + 1] = chain_offsets[i] + c.shape[0]
    flat = np.concatenate(chains) if chains else np.zeros(0, np.int64)

    # RC pairing by path.
    id_pos = {eid: i for i, eid in enumerate(eids)}
    rc_edge = np.arange(n, dtype=np.int64)
    for i, eid in enumerate(eids):
        rc = g.edges[eid].rc
        if rc in id_pos:
            rc_edge[i] = id_pos[rc]
        else:
            # Find by path (pre-detangle edges keep their original rc).
            rc_path = tuple(
                int(ag.rc_edge[x]) for x in reversed(g.edges[eid].path)
            )
            for j, ej in enumerate(eids):
                if tuple(g.edges[ej].path) == rc_path:
                    rc_edge[i] = j
                    break

    return AssemblyGraph(
        chain_offsets=chain_offsets,
        chains=flat,
        rc_edge=rc_edge,
        source_v=np.array(src_v, dtype=np.int64),
        target_v=np.array(tgt_v, dtype=np.int64),
        is_circular=np.zeros(n, dtype=bool),
    )
