// Host C++ for the port's assembly-graph stages, built into the port's
// native library with native/*.cpp (shasta_tpu_torch/native.py:_SRCS)
// and called through ctypes.
//
// condense_chains: condense the alive marker-graph edges into maximal
// linear chains, the assembly graph's edges (reference:
// createAssemblyGraphEdges, src/AssemblerAssemblyGraph.cpp:38-230), in
// sequential O(E) passes, in the JAX package's order
// (shasta_tpu/graph/assembly_graph.py:create_assembly_graph): starts in
// ascending edge id, each chain from its walk back to its walk forward,
// a cycle from its smallest unfound edge, and each reverse complement
// chain right after its chain unless the chain is its own. An edge id
// below 0 in rc_edge indexes from the end, as numpy's fancy indexing
// does, so the output equals the numpy program on every input.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// I is the index type of source, target and rc_edge (int32_t or int64_t),
// and of the vertex arrays built here.
template <typename I>
int64_t condense(
    int64_t n_edges,
    int64_t n_vertices,
    const I* source,
    const I* target,
    const I* rc_edge,
    const uint8_t* alive,
    int64_t* chain_offsets,
    int64_t* chains,
    int64_t* rc_out,
    int64_t* source_v,
    int64_t* target_v,
    uint8_t* is_circular)
{
    // The alive edges in ascending id, compacted without a branch on the
    // mask (one on each edge of a mask like the alive edges' mispredicts):
    // every later pass reads only them.
    std::vector<I> live(n_edges);
    int64_t n_live = 0;
    for (int64_t e = 0; e < n_edges; e++) {
        live[n_live] = (I)e;
        n_live += alive[e];
    }
    // A vertex's one alive out-edge (in-edge), -1 for none and -2 for
    // several.
    std::vector<I> only_out(n_vertices, -1), only_in(n_vertices, -1);
    for (int64_t j = 0; j < n_live; j++) {
        const I e = live[j];
        const int64_t s = source[e], t = target[e], r = rc_edge[e];
        if (s < 0 || s >= n_vertices || t < 0 || t >= n_vertices ||
            r < -n_edges || r >= n_edges)
            return -1;
        only_out[s] = only_out[s] == -1 ? e : (I)-2;
        only_in[t] = only_in[t] == -1 ? e : (I)-2;
    }
    // A chain passes through v where v has one alive edge each way; keep
    // those and clear the rest, so that an alive edge's successor is
    // only_out[target] and its predecessor only_in[source], -1 for none.
    for (int64_t v = 0; v < n_vertices; v++) {
        const bool linear = only_out[v] >= 0 && only_in[v] >= 0;
        only_out[v] = linear ? only_out[v] : (I)-1;
        only_in[v] = linear ? only_in[v] : (I)-1;
    }
    auto next = [&](int64_t e) -> int64_t { return only_out[target[e]]; };
    auto prev = [&](int64_t e) -> int64_t { return only_in[source[e]]; };
    auto wrap = [n_edges](int64_t e) { return e < 0 ? e + n_edges : e; };

    // One bit an edge, so that the set touches few pages.
    std::vector<uint64_t> found((n_edges + 63) / 64, 0);
    auto is_found = [&](int64_t e) { return (found[e >> 6] >> (e & 63)) & 1; };
    auto set_found = [&](int64_t e) { found[e >> 6] |= uint64_t(1) << (e & 63); };
    int64_t n_chains = 0;
    int64_t pos = 0;
    chain_offsets[0] = 0;
    for (int64_t j = 0; j < n_live; j++) {
        const int64_t start = live[j];
        if (is_found(start)) continue;
        // The walk back comes round to start exactly where the chain is a
        // cycle, which then runs from start; a path runs from the walk's
        // last edge. prev and next are inverse, so the walk forward from
        // there writes the walk back reversed, start and the walk forward.
        int64_t first = start;
        bool circ = false;
        for (int64_t e = prev(start); e != -1; e = prev(e)) {
            if (e == start) {
                circ = true;
                first = start;
                break;
            }
            first = e;
        }
        int64_t* chain = chains + pos;
        int64_t len = 0;
        for (int64_t e = first; e != -1 && (len == 0 || e != first); e = next(e)) {
            chain[len++] = e;
            set_found(e);
        }

        // The reverse complement chain: rc_edge of the chain, reversed.
        bool self_comp = true;
        if (circ) {
            const int64_t r0 = rc_edge[chain[len - 1]];
            self_comp = std::find(chain, chain + len, r0) != chain + len;
        } else {
            for (int64_t i = 0; i < len && self_comp; i++)
                self_comp = chain[i] == rc_edge[chain[len - 1 - i]];
        }

        const int64_t cid = n_chains;
        source_v[cid] = source[chain[0]];
        target_v[cid] = target[chain[len - 1]];
        is_circular[cid] = circ;
        pos += len;
        chain_offsets[cid + 1] = pos;
        if (self_comp) {
            rc_out[cid] = cid;
            n_chains = cid + 1;
            continue;
        }
        int64_t* rc_chain = chains + pos;
        for (int64_t i = 0; i < len; i++) {
            rc_chain[i] = rc_edge[chain[len - 1 - i]];
            set_found(wrap(rc_chain[i]));
        }
        source_v[cid + 1] = source[wrap(rc_chain[0])];
        target_v[cid + 1] = target[wrap(rc_chain[len - 1])];
        is_circular[cid + 1] = circ;
        pos += len;
        chain_offsets[cid + 2] = pos;
        rc_out[cid] = cid + 1;
        rc_out[cid + 1] = cid;
        n_chains = cid + 2;
    }
    return n_chains;
}

}  // namespace

extern "C" {

// Writes n_chains chains into chain_offsets [n_chains + 1], chains,
// rc_out, source_v, target_v and is_circular, and returns n_chains, or
// -1 where an alive edge's vertex lies outside [0, n_vertices) or its
// reverse complement outside [-n_edges, n_edges). source, target and rc_edge
// are int32 where idx32 is 1, else int64. The caller sizes every output
// for 2 x the alive edge count (chains) and 2 x that + 1
// (chain_offsets): direct chains are disjoint, and a reverse complement
// chain is as long as its chain.
int64_t condense_chains(
    int64_t n_edges,
    int64_t n_vertices,
    const void* source,
    const void* target,
    const void* rc_edge,
    int64_t idx32,
    const uint8_t* alive,
    int64_t* chain_offsets,
    int64_t* chains,
    int64_t* rc_out,
    int64_t* source_v,
    int64_t* target_v,
    uint8_t* is_circular)
{
    if (idx32)
        return condense<int32_t>(
            n_edges, n_vertices, (const int32_t*)source, (const int32_t*)target,
            (const int32_t*)rc_edge, alive, chain_offsets, chains, rc_out,
            source_v, target_v, is_circular);
    return condense<int64_t>(
        n_edges, n_vertices, (const int64_t*)source, (const int64_t*)target,
        (const int64_t*)rc_edge, alive, chain_offsets, chains, rc_out,
        source_v, target_v, is_circular);
}

}  // extern "C"
