"""The assembly-graph condensation's callers on the simplify path against
the JAX package: each chain's mean coverage, simplifyMarkerGraph's
superbubble flags and removeLowCoverageCrossEdges' flags, on a seeded
strand-symmetric marker graph with bubbles and superbubbles."""

import numpy as np
import pytest

from shasta_tpu.graph import assembly_graph as ref_AG
from shasta_tpu.graph import marker_graph as ref_MG
from shasta_tpu.graph import simplify as ref_SG
from shasta_tpu_torch import native
from shasta_tpu_torch.graph import assembly_graph as AG
from shasta_tpu_torch.graph import marker_graph as MG
from shasta_tpu_torch.graph import simplify as SG

MAX_LENGTHS = [10, 100, 1000]


def bubble_graph_arrays(seed, backbone=400, detours=90):
    """A backbone path of high coverage with detours of low coverage: a
    path of 0 to 3 new vertices from backbone vertex i to i + 1 to i + 6.
    Overlapping detours make superbubbles, lone ones bubbles, and a few
    links between detours cross edges. Forward vertex v is marker-graph
    vertex 2 v and its reverse complement 2 v + 1."""
    rng = np.random.default_rng(seed)
    edges = [(v, v + 1, int(rng.integers(15, 30))) for v in range(backbone)]
    n = backbone + 1
    inner = []
    for _ in range(detours):
        i = int(rng.integers(0, backbone - 6))
        j = i + int(rng.integers(1, 7))
        path = [i] + list(range(n, n + int(rng.integers(0, 4)))) + [j]
        n += len(path) - 2
        inner += path[1:-1]
        cov = int(rng.integers(1, 12))
        edges += [(a, b, cov) for a, b in zip(path, path[1:])]
    for _ in range(detours // 6):
        a, b = rng.choice(inner, 2, replace=False)
        edges.append((int(a), int(b), int(rng.integers(1, 4))))
    edges = {(a, b): c for a, b, c in edges if a != b}
    fwd = np.array([(2 * a, 2 * b, c) for (a, b), c in edges.items()], np.int64)
    n_v = 2 * n
    # Each forward edge with its reverse complement (t ^ 1) -> (s ^ 1).
    s = np.concatenate([fwd[:, 0], fwd[:, 1] ^ 1])
    t = np.concatenate([fwd[:, 1], fwd[:, 0] ^ 1])
    c = np.concatenate([fwd[:, 2], fwd[:, 2]])
    keys, first = np.unique(s * n_v + t, return_index=True)
    src, tgt = keys // n_v, keys % n_v
    rc_edge = np.searchsorted(keys, (tgt ^ 1) * n_v + (src ^ 1))
    m = keys.shape[0]
    cov = c[first].astype(np.int32)
    ioff = np.zeros(m + 1, np.int64)
    np.cumsum(cov, out=ioff[1:])
    n_iv = int(ioff[-1])
    return dict(
        vertex_table=np.zeros(0, np.int64),
        vertex_offsets=np.arange(n_v + 1, dtype=np.int64),
        vertex_markers=np.arange(n_v, dtype=np.int64),
        rc_vertex=np.arange(n_v, dtype=np.int64) ^ 1,
        source=src, target=tgt, coverage=cov, rc_edge=rc_edge.astype(np.int64),
        removed_tr=np.zeros(m, bool), pruned=np.zeros(m, bool),
        superbubble=np.zeros(m, bool), low_coverage_cross=np.zeros(m, bool),
        interval_offsets=ioff, interval_orid=np.zeros(n_iv, np.int64),
        interval_ord0=np.zeros(n_iv, np.int32), interval_ord1=np.ones(n_iv, np.int32),
    )


def graph_pair(seed):
    arrays = bubble_graph_arrays(seed)
    copy = lambda: {k: np.copy(v) for k, v in arrays.items()}  # noqa: E731
    return ref_MG.MarkerGraph(**copy()), MG.MarkerGraph(**copy())


def loop_mean_coverage(ag, coverage):
    """The per-chain loop that chain_mean_coverage replaced."""
    out = np.zeros(ag.edge_count, dtype=np.int64)
    for e in range(ag.edge_count):
        chain = ag.chain(e)
        if chain.shape[0]:
            out[e] = int(coverage[chain].sum()) // chain.shape[0]
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_chain_mean_coverage_equals_loop(seed):
    """On the condensed graph, and on one with empty chains and a chain
    whose reverse complement is missing (-1 reads the last edge)."""
    _, mg = graph_pair(seed)
    ag = AG.create_assembly_graph(mg)
    got = AG.chain_mean_coverage(ag, mg.coverage)
    assert got.dtype == np.int64
    assert np.array_equal(got, loop_mean_coverage(ag, mg.coverage))
    assert np.unique(got).shape[0] > 5
    chains = np.concatenate([ag.chains[:7], [-1, 3]])
    odd = AG.AssemblyGraph(
        chain_offsets=np.array([0, 0, 3, 3, 7, 9], np.int64), chains=chains,
        rc_edge=np.arange(5), source_v=np.zeros(5, np.int64),
        target_v=np.zeros(5, np.int64), is_circular=np.zeros(5, bool),
    )
    assert np.array_equal(AG.chain_mean_coverage(odd, mg.coverage),
                          loop_mean_coverage(odd, mg.coverage))


@pytest.mark.parametrize("seed", [1, 2])
def test_simplify_and_cross_edges_equal_reference(seed):
    """simplifyMarkerGraph at maxLength 10, 100, 1000, then
    removeLowCoverageCrossEdges on the condensed result, flag the same
    edges as the JAX package's, and both parts remove something."""
    ref_mg, mg = graph_pair(seed)
    stats = SG.simplify_marker_graph(mg, MAX_LENGTHS)
    assert stats == ref_SG.simplify_marker_graph(ref_mg, MAX_LENGTHS)
    assert stats["bubbles_removed"] > 0 and stats["superbubble_edges_removed"] > 0
    assert np.array_equal(mg.superbubble, ref_mg.superbubble)
    ag = AG.create_assembly_graph(mg)
    ref_ag = ref_AG.create_assembly_graph(ref_mg)
    n = AG.remove_low_coverage_cross_edges(ag, mg, 3)
    assert n == ref_AG.remove_low_coverage_cross_edges(ref_ag, ref_mg, 3)
    assert n > 0
    assert np.array_equal(mg.low_coverage_cross, ref_mg.low_coverage_cross)
    assert np.array_equal(mg.superbubble, ref_mg.superbubble)


@pytest.mark.parametrize("field, value", [("source", -1), ("target", 10**6), ("rc_edge", 10**6)])
def test_condense_rejects_an_alive_edge_out_of_range(field, value):
    """An alive edge whose vertex or reverse complement lies out of range
    raises; the same value on a dead edge is never read."""
    _, mg = graph_pair(1)
    arrays = {k: getattr(mg, k).copy() for k in ("source", "target", "rc_edge")}
    alive = mg.alive()
    arrays[field][0] = value
    with pytest.raises(ValueError, match="out of range"):
        native.condense_chains_native(**arrays, alive=alive, n_vertices=mg.vertex_count)
    alive[0] = False
    native.condense_chains_native(**arrays, alive=alive, n_vertices=mg.vertex_count)
