"""Mode-0 assembly: marker-graph consensus, linear-chain condensation,
segment stitching, GFA/FASTA output.

Counterpart of the reference mode-0 assembly stage
(reference: src/AssemblerAssemblyGraph.cpp, src/AssembledSegment.cpp,
src/AssemblerMarkerGraph.cpp:3179+ for edge consensus, :4509+ for
vertex repeat counts). The structure follows the reference's call
sequence (srcMain/main.cpp:913-1036):

  assembleMarkerGraphVertices -> assembleMarkerGraphEdges ->
  createAssemblyGraphEdges/Vertices -> assemble -> writers

Vertex repeat-count consensus is computed for ALL vertices in one
vectorized histogram pass per k-mer position (instead of a loop over
vertices); edge consensus loops over edges on host with a batched NW
center-star MSA (see shasta_tpu_torch.consensus.msa).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from shasta_tpu_torch import native
from shasta_tpu_torch.consensus import msa as MSA
from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.data.reads import ReadStore
from shasta_tpu_torch.graph.marker_graph import MarkerGraph
from shasta_tpu_torch.utils.perf import span

GAP = 4


# ---------------------------------------------------------------------------
# Oriented-read access helpers
# ---------------------------------------------------------------------------


def oriented_positions_to_flat(
    reads: ReadStore, orid: int, positions: np.ndarray
) -> Tuple[np.ndarray, bool]:
    """Flat indices into reads.rle_bases for RLE positions of an
    oriented read; bool says whether bases must be complemented."""
    rid = orid >> 1
    lo, hi = reads.offsets[rid], reads.offsets[rid + 1]
    if orid & 1:
        return hi - 1 - positions, True
    return lo + positions, False


def oriented_base_repeat(reads: ReadStore, orid: int, positions: np.ndarray):
    idx, comp = oriented_positions_to_flat(reads, orid, positions)
    b = reads.rle_bases[idx]
    if comp:
        b = 3 - b
    return b, reads.repeat_counts[idx]


def batch_fill_sequences(
    reads: ReadStore,
    orids: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
):
    """RLE (bases, repeats) for position ranges [start, end) of many
    oriented reads at once, as one flat CSR (offsets int64 [n+1]).
    One vectorized pass replaces per-interval oriented_base_repeat
    calls, which dominate edge-consensus wall time at genome scale.
    The flat index is a fused per-interval base + t*step expansion in
    int32 when the RLE space fits (~12 B/position vs the five int64
    expansions this replaces — part of the assembleMarkerGraphEdges
    27.8 GB peak at SCALE=50, memprof r4)."""
    lens = np.maximum(ends - starts, 0).astype(np.int64)
    off = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    n = int(off[-1])
    idt = np.int32 if max(n, int(reads.offsets[-1])) < 2**31 else np.int64
    rid = (orids >> 1).astype(np.int64)
    rev = (orids & 1).astype(bool)
    lo = reads.offsets[rid]
    hi = reads.offsets[rid + 1]
    base_iv = np.where(rev, hi - 1 - starts, lo + starts).astype(idt)
    step_iv = np.where(rev, np.int8(-1), np.int8(1))
    idx = np.repeat(base_iv, lens)
    t = np.arange(n, dtype=idt) - np.repeat(off[:-1].astype(idt), lens)
    idx += t * np.repeat(step_iv, lens)
    del t
    rev_pos = np.repeat(rev, lens)
    b = reads.rle_bases[idx]
    b = np.where(rev_pos, 3 - b, b).astype(np.uint8)
    return b, reads.repeat_counts[idx], off


def unpack_kmer(kmer_id: int, k: int) -> np.ndarray:
    """MSB-first packed k-mer id -> base codes."""
    out = np.empty(k, dtype=np.uint8)
    x = int(kmer_id)
    for i in range(k - 1, -1, -1):
        out[i] = x & 3
        x >>= 2
    return out


# ---------------------------------------------------------------------------
# Vertex consensus (repeat counts per k-mer position)
# ---------------------------------------------------------------------------


def assemble_marker_graph_vertices(
    reads: ReadStore,
    markers: MarkerStore,
    mg: MarkerGraph,
    caller: str = "Modal",
    max_repeat: int = 256,
    chunk_markers: int = 1 << 24,
) -> np.ndarray:
    """Consensus repeat count for each of the k positions of each
    vertex (reference: assembleMarkerGraphVertices,
    src/AssemblerMarkerGraph.cpp:4509). The base sequence of a vertex
    is its k-mer; only repeat counts need consensus.

    Returns int32 [n_vertices, k]. Fully vectorized: one histogram
    bincount per k-mer position over a vertex-aligned marker chunk at
    a time — every temporary (gathered positions, fused keys, the
    (vertices, width) histogram) is O(chunk), so the stage's transient
    RSS is flat in genome size (memprof r4: the whole-graph variant
    peaked at 16.4 GB at SCALE=50 over a 318 MB output; the per-j
    int64 keys, bincount's internal intp copy, and the full
    n_v*width histogram were the whales).
    """
    k = markers.k
    n_v = mg.vertex_count
    out = np.zeros((n_v, k), dtype=np.int32)
    if n_v == 0:
        return out
    if caller not in ("Modal", "Median"):
        raise ValueError(f"Unsupported vertex caller {caller!r}")

    moff = markers.offsets
    total = markers.total_count
    idt = (
        np.int32
        if max(total, int(reads.offsets[-1])) < 2**31
        else np.int64
    )
    voff = mg.vertex_offsets
    vm_all = mg.vertex_markers  # flat marker ids, grouped by vertex

    v0 = 0
    while v0 < n_v:
        # Advance to the vertex boundary at (or just past) chunk_markers
        # in-vertex markers, so every vertex's histogram is complete
        # within one chunk and the result is byte-identical to the
        # whole-graph pass.
        v1 = int(np.searchsorted(voff, voff[v0] + chunk_markers, "left"))
        v1 = max(v0 + 1, min(v1, n_v))
        s0, s1 = int(voff[v0]), int(voff[v1])
        vm = vm_all[s0:s1]
        nvc = v1 - v0
        v_of = np.repeat(
            np.arange(nvc, dtype=idt), np.diff(voff[v0 : v1 + 1])
        )
        # Oriented read of each chunk marker by CSR bisection (avoids
        # materializing a read id per marker for the whole store).
        orid = (np.searchsorted(moff, vm, "right") - 1).astype(idt)
        pos = markers.positions[vm].astype(idt)  # RLE marker start

        # Flat index of RLE position (pos + j) per oriented read:
        # idx_j = base + j*step (step -1 on the reversed strand).
        rid = orid >> 1
        rev = (orid & 1).astype(bool)
        lo = reads.offsets[rid].astype(idt)
        hi = reads.offsets[rid + 1].astype(idt)
        base = np.where(rev, hi - 1 - pos, lo + pos)
        step = np.where(rev, np.int8(-1), np.int8(1))
        del orid, pos, rid, rev, lo, hi

        for j in range(k):
            idx = base + j * step
            rc = np.minimum(reads.repeat_counts[idx], max_repeat - 1)
            # bincount over a fused (vertex, repeat) key with the width
            # trimmed to the largest repeat present in the chunk (a
            # narrower chunk-local width cannot change argmax: absent
            # columns are zero and every vertex has coverage >= 1).
            width = int(rc.max()) + 1 if rc.shape[0] else 1
            kdt = np.int64 if nvc * width >= 2**31 else np.int32
            hist = np.bincount(
                v_of.astype(kdt, copy=False) * kdt(width) + rc,
                minlength=nvc * width,
            ).reshape(nvc, width)
            if caller == "Modal":
                out[v0:v1, j] = np.argmax(hist, axis=1)
            else:  # Median
                c = np.cumsum(hist, axis=1)
                half = c[:, -1:] // 2
                out[v0:v1, j] = np.argmax(c > half, axis=1)
        v0 = v1
    return out


# ---------------------------------------------------------------------------
# Edge consensus
# ---------------------------------------------------------------------------


@dataclass
class EdgeConsensus:
    """Per marker-graph edge: consensus fill sequence between the two
    vertex k-mers (RLE codes + repeat counts) or an overlapping base
    count when the k-mers overlap (reference: the
    (sequence, repeatCounts, overlappingBaseCount) triple of
    computeMarkerGraphEdgeConsensusSequenceUsingSpoa)."""

    offsets: np.ndarray  # int64 [n_edges+1] into seq/rep
    seq: np.ndarray  # uint8 flat
    rep: np.ndarray  # int32 flat
    overlap: np.ndarray  # int32 [n_edges]

    def get(self, e: int):
        lo, hi = self.offsets[e], self.offsets[e + 1]
        return self.seq[lo:hi], self.rep[lo:hi], int(self.overlap[e])

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "offsets": self.offsets,
            "seq": self.seq,
            "rep": self.rep,
            "overlap": self.overlap,
        }

    @classmethod
    def from_arrays(cls, a) -> "EdgeConsensus":
        return cls(offsets=a["offsets"], seq=a["seq"], rep=a["rep"], overlap=a["overlap"])


def _native_mode2_consensus(
    caller, caller_name, k, slow_edges, has_long, edge_of_iv,
    iv_off, iv_sel, fill_b, fill_r, fill_off,
):
    """Batched native consensus for ALL mode-2 edges (native/poa.cpp
    edge_consensus_batch: dedup + POA + column consensus per edge,
    threaded over 4-8 cores like the reference's thread pool).
    Returns (edges, lengths, dense col_offsets, seq, rep), or None when
    no edge qualifies."""
    from shasta_tpu_torch import native

    slow_mask = np.zeros(has_long.shape[0], bool)
    slow_mask[slow_edges] = True
    mode2_mask = slow_mask & ~has_long
    u_iv = np.flatnonzero(mode2_mask[edge_of_iv[iv_sel]] & (iv_off[iv_sel] > k))
    if u_iv.shape[0] == 0:
        return None
    e_iv = edge_of_iv[iv_sel[u_iv]]
    m2_edges = np.unique(e_iv)
    starts = np.searchsorted(e_iv, m2_edges)
    edge_iv_off = np.concatenate([starts, [u_iv.shape[0]]]).astype(np.int64)

    mode = {"Modal": 0, "Median": 1}.get(caller_name, 2)
    kwargs = {}
    if mode == 2:
        kwargs = dict(
            priors=caller.model.priors, likelihood=caller.model.likelihood
        )
    out_b, out_r, out_len = native.edge_consensus_batch_native(
        fill_b, fill_r, fill_off, u_iv, edge_iv_off, mode, **kwargs
    )  # already compacted per edge
    col_off = np.zeros(m2_edges.shape[0] + 1, np.int64)
    np.cumsum(out_len, out=col_off[1:])
    return m2_edges, out_len, col_off, out_b, out_r


def assemble_marker_graph_edges(
    reads: ReadStore,
    markers: MarkerStore,
    mg: MarkerGraph,
    needed: Optional[np.ndarray] = None,
    caller=None,
    length_threshold_markers: int = 1000,
    length_threshold_bases: int = 1000,
) -> EdgeConsensus:
    """Consensus fill sequence of each (needed) marker graph edge
    (reference: computeMarkerGraphEdgeConsensusSequenceUsingSpoa,
    src/AssemblerMarkerGraph.cpp:3179-3660).

    Per edge, with k = marker length and per-interval marker positions
    (position0, position1):
    - long intervals (ordinal skip > length_threshold_markers or RLE
      span > length_threshold_bases) -> use the shortest interval's
      literal sequence;
    - otherwise pick mode 1 (offset <= k: overlapping/adjacent markers,
      consensus = most frequent offset) or mode 2 (intervening
      sequence: MSA of distinct sequences by decreasing frequency,
      per-column caller consensus) by majority.
    """
    from shasta_tpu_torch.consensus.caller import ModalConsensusCaller

    if caller is None:
        caller = ModalConsensusCaller()
    k = markers.k
    n_edges = mg.edge_count
    moff = markers.offsets

    seq_rows: List[np.ndarray] = []
    rep_rows: List[np.ndarray] = []
    overlap = np.zeros(n_edges, dtype=np.int32)
    offsets = np.zeros(n_edges + 1, dtype=np.int64)

    pos_flat = markers.positions

    # Vectorized pre-pass over ALL intervals: per-interval marker
    # offsets and mode classification, reduced per edge. The dominant
    # mode-1 case (overlapping/adjacent markers, consensus = most
    # frequent offset <= k) is then resolved without any per-edge
    # Python work; only mode-2/pathological edges take the slow path.
    # Interval index arrays stay int32 (10^8 intervals at SCALE=50;
    # the int64 expansions and float64 bincount-weight temps here were
    # most of the stage's 33.2 GB RSS peak, memprof r4).
    n_iv = mg.interval_orid.shape[0]
    idt = np.int32 if max(n_iv, n_edges, len(pos_flat)) < 2**31 else np.int64
    edge_of_iv = np.repeat(
        np.arange(n_edges, dtype=idt), np.diff(mg.interval_offsets)
    )
    # Chunked position gathers: the full-size int64 index temp
    # (moff[orid] + ord, twice) cost ~5 GB at the 150 Mb scale.
    iv_p0 = np.empty(n_iv, idt)
    iv_p1 = np.empty(n_iv, idt)
    for lo in range(0, n_iv, 1 << 24):
        hi = min(lo + (1 << 24), n_iv)
        base = moff[mg.interval_orid[lo:hi]]
        iv_p0[lo:hi] = pos_flat[base + mg.interval_ord0[lo:hi]]
        iv_p1[lo:hi] = pos_flat[base + mg.interval_ord1[lo:hi]]
        del base
    iv_off = iv_p1 - iv_p0
    # ord1 >= ord0 always, so the unsigned uint16 difference is exact.
    iv_skip = mg.interval_ord1 - mg.interval_ord0

    has_long = np.zeros(n_edges, dtype=bool)
    has_long[
        edge_of_iv[
            (iv_skip > length_threshold_markers)
            | (iv_off > length_threshold_bases)
        ]
    ] = True
    mode1_per_edge = np.bincount(
        edge_of_iv[iv_off <= k], minlength=n_edges
    )
    total_per_edge = np.bincount(edge_of_iv, minlength=n_edges)
    is_mode1 = (~has_long) & (mode1_per_edge >= total_per_edge - mode1_per_edge)

    # Mode-1 best offsets for all such edges, histogrammed in
    # edge-chunks (ties -> smaller offset, like the reference's
    # max_element). edge_of_iv is nondecreasing (np.repeat of arange),
    # so each chunk is a contiguous interval slice; the monolithic
    # (n_edges, k+1) int64 histogram this replaces was the stage's
    # largest remaining transient (~6 GB at SCALE=50, ~12 GB at the
    # 100 Mb ONT scale — the 19.5/32.5 GB stage peaks in SCALE_r05).
    sel_mask = is_mode1[edge_of_iv] & (iv_off <= k)
    best_offset_all = np.zeros(n_edges, np.int32)
    _CH = 1 << 22  # 4M edges/chunk: (4M, k+1) int64 hist ~= 0.5 GB
    for lo in range(0, n_edges, _CH):
        hi = min(lo + _CH, n_edges)
        s = np.searchsorted(edge_of_iv, lo, side="left")
        e = np.searchsorted(edge_of_iv, hi, side="left")
        m = sel_mask[s:e]
        keys = (edge_of_iv[s:e][m].astype(np.int64) - lo) * np.int64(
            k + 1
        ) + iv_off[s:e][m]
        hist = np.bincount(keys, minlength=(hi - lo) * (k + 1)).reshape(
            hi - lo, k + 1
        )
        best_offset_all[lo:hi] = np.argmax(hist, axis=1).astype(np.int32)
        del keys, hist
    del sel_mask

    # Mode-1 edges (the overwhelming majority) resolve without any
    # per-edge Python; the loop below visits only mode-2/pathological
    # edges (at genome scale, iterating all edges in Python costs more
    # than the consensus work itself).
    needed_mask = (
        np.ones(n_edges, bool) if needed is None
        else np.asarray(needed, bool)
    )
    fast = needed_mask & is_mode1
    overlap[fast] = (k - best_offset_all[fast]).astype(np.int32)
    lengths = np.zeros(n_edges, np.int64)
    slow_edges = np.flatnonzero(needed_mask & ~is_mode1)

    # One vectorized pass extracts every slow-edge interval's fill
    # sequence (positions [p0+k, p1)); the loop then only slices.
    slow_edge_mask = np.zeros(n_edges, bool)
    slow_edge_mask[slow_edges] = True
    iv_sel = np.flatnonzero(slow_edge_mask[edge_of_iv]).astype(idt)
    fill_b, fill_r, fill_off = batch_fill_sequences(
        reads,
        mg.interval_orid[iv_sel],
        iv_p0[iv_sel].astype(np.int64) + k,
        iv_p1[iv_sel].astype(np.int64),
    )
    fill_of_iv = np.full(n_iv, -1, idt)
    fill_of_iv[iv_sel] = np.arange(iv_sel.shape[0], dtype=idt)

    # ---- Mode-2 edges: the native batch ----
    # Every mode-2 edge without a long interval (dedup + POA + column
    # consensus in C++, threaded); the loop below then visits only the
    # edges it does not take: long intervals, and every slow edge of a
    # caller the batch does not implement.
    batch_results = None
    caller_name = getattr(caller, "name", "")
    fast_capable = caller_name in ("Modal", "Median") or hasattr(
        caller, "repeat_counts_batch"
    )
    if fast_capable and slow_edges.shape[0]:
        batch_results = _native_mode2_consensus(
            caller, caller_name, k, slow_edges, has_long, edge_of_iv,
            iv_off, iv_sel, fill_b, fill_r, fill_off,
        )
    if batch_results is not None:
        u_edges, u_len, u_col_off, u_seq, u_rep = batch_results
        lengths[u_edges] = u_len
        done_mask = np.zeros(n_edges, bool)
        done_mask[u_edges] = True
        slow_edges = slow_edges[~done_mask[slow_edges]]

    slow_row_edges: List[int] = []

    for e in slow_edges:
        e = int(e)
        rows = np.arange(
            mg.interval_offsets[e], mg.interval_offsets[e + 1],
            dtype=np.int64,
        )
        orids = mg.interval_orid[rows]
        m = orids.shape[0]
        p0 = iv_p0[rows]
        p1 = iv_p1[rows]
        offs = iv_off[rows]
        skips = iv_skip[rows]
        rle_span = offs

        def _fill(row):
            j = fill_of_iv[row]
            lo, hi = fill_off[j], fill_off[j + 1]
            return fill_b[lo:hi], fill_r[lo:hi]

        if (skips > length_threshold_markers).any() or (
            rle_span > length_threshold_bases
        ).any():
            # Pathological: shortest interval literally.
            i = int(np.argmin(skips))
            if p1[i] > p0[i] + k:
                b, r = _fill(rows[i])
                seq_rows.append(b)
                rep_rows.append(r.astype(np.int32))
                slow_row_edges.append(e)
                overlap[e] = 0
                lengths[e] = b.shape[0]
            else:
                overlap[e] = int(p0[i] + k - p1[i])
            continue

        mode1 = offs <= k
        if mode1.sum() >= m - mode1.sum():
            # Mode 1: most frequent offset (ties -> smaller offset).
            hist = np.bincount(offs[mode1].astype(np.int64), minlength=k + 1)
            best_offset = int(np.argmax(hist))
            overlap[e] = k - best_offset
            continue

        # Mode 2: MSA of intervening sequences.
        used = np.flatnonzero(~mode1)
        seqs: List[np.ndarray] = []
        reps: List[np.ndarray] = []
        for i in used:
            b, r = _fill(rows[i])
            seqs.append(b)
            reps.append(r)

        # Distinct sequences in order of decreasing frequency
        # (stable: ties by first encountered).
        keys: Dict[bytes, int] = {}
        occurrences: List[List[int]] = []
        for t, s in enumerate(seqs):
            kb = s.tobytes()
            if kb in keys:
                occurrences[keys[kb]].append(t)
            else:
                keys[kb] = len(occurrences)
                occurrences.append([t])
        order = sorted(
            range(len(occurrences)), key=lambda K: (-len(occurrences[K]), K)
        )
        distinct = [seqs[occurrences[K][0]] for K in order]
        occ_sorted = [occurrences[K] for K in order]

        rows = MSA.poa_msa(distinct)
        width = rows[0].shape[0]

        # Vectorized column consensus: expand aligned rows and repeat
        # counts to (n_used, width) matrices, then call per column via
        # histogram reductions (Modal/Median) or the caller loop only
        # for the Bayesian model.
        n_used = len(seqs)
        row_of_t = np.empty(n_used, np.int64)
        for row_i, occ in enumerate(occ_sorted):
            for t in occ:
                row_of_t[t] = row_i
        rows_mat = np.stack(rows)  # (n_distinct, width)
        nz_pos = [np.flatnonzero(r != GAP) for r in rows_mat]
        base_m = rows_mat[row_of_t]
        rep_m = np.zeros((n_used, width), np.int32)
        for t in range(n_used):
            rep_m[t, nz_pos[int(row_of_t[t])]] = reps[t]

        caller_name = getattr(caller, "name", "")
        if caller_name in ("Modal", "Median") and width:
            # Base histogram (5, width) via bincount (add.at is slow).
            cols_idx = np.tile(np.arange(width, dtype=np.int64), n_used)
            bh = np.bincount(
                base_m.ravel().astype(np.int64) * width + cols_idx,
                minlength=5 * width,
            ).reshape(5, width)
            cons_base = np.argmax(bh, axis=0).astype(np.uint8)
            keep_cols = cons_base != GAP
            # Repeat consensus among entries matching the consensus base.
            match = base_m == cons_base[None, :]
            max_rep = int(rep_m.max()) + 1 if rep_m.size else 1
            midx = np.flatnonzero(match.ravel())
            rh = np.bincount(
                rep_m.ravel().astype(np.int64)[midx] * width + cols_idx[midx],
                minlength=max_rep * width,
            ).reshape(max_rep, width)
            if caller_name == "Modal":
                cons_rep_all = np.argmax(rh, axis=0)
            else:  # Median (upper)
                c = np.cumsum(rh, axis=0)
                half = c[-1] // 2
                cons_rep_all = np.argmax(c > half[None, :], axis=0)
            cons_seq_arr = cons_base[keep_cols]
            cons_rep_arr = np.maximum(cons_rep_all[keep_cols], 1).astype(np.int32)
        elif hasattr(caller, "consensus_columns"):
            # Vectorized column consensus (Bayesian): one histogram +
            # 4 likelihood matmuls per edge instead of per-column
            # Python calls.
            cb, cr = caller.consensus_columns(base_m, rep_m)
            keep = cb != GAP
            cons_seq_arr = cb[keep]
            cons_rep_arr = np.maximum(cr[keep], 1).astype(np.int32)
        else:
            cons_seq_l: List[int] = []
            cons_rep_l: List[int] = []
            for col in range(width):
                b, r = caller(base_m[:, col], rep_m[:, col])
                if b != GAP:
                    cons_seq_l.append(b)
                    cons_rep_l.append(max(1, r))
            cons_seq_arr = np.array(cons_seq_l, dtype=np.uint8)
            cons_rep_arr = np.array(cons_rep_l, dtype=np.int32)

        seq_rows.append(cons_seq_arr)
        rep_rows.append(cons_rep_arr)
        slow_row_edges.append(e)
        overlap[e] = 0
        lengths[e] = cons_seq_arr.shape[0]

    np.cumsum(lengths, out=offsets[1:])
    total = int(offsets[-1])
    seq = np.zeros(total, np.uint8)
    rep = np.zeros(total, np.int32)
    if batch_results is not None and total:
        # Bulk scatter of the fast-path consensus into edge order.
        dst = np.repeat(offsets[u_edges], u_len) + (
            np.arange(int(u_col_off[-1]), dtype=np.int64)
            - np.repeat(u_col_off[:-1], u_len)
        )
        seq[dst] = u_seq
        rep[dst] = u_rep
    for e, b, r in zip(slow_row_edges, seq_rows, rep_rows):
        lo = offsets[e]
        seq[lo : lo + b.shape[0]] = b
        rep[lo : lo + r.shape[0]] = r
    return EdgeConsensus(offsets=offsets, seq=seq, rep=rep, overlap=overlap)


# ---------------------------------------------------------------------------
# Assembly graph (linear chain condensation)
# ---------------------------------------------------------------------------


@dataclass
class AssemblyGraph:
    """Edges are linear chains of marker-graph edges
    (reference: src/AssemblyGraph.hpp:33-120). ``chain_offsets``/
    ``chains`` is the CSR of marker-graph edge ids per assembly edge
    (the reference's edgeLists); rc pairing follows the reference
    convention: an edge is assembled iff edge_id <= rc_edge[edge_id]."""

    chain_offsets: np.ndarray  # int64 [n_edges+1]
    chains: np.ndarray  # int64 flat marker-graph edge ids
    rc_edge: np.ndarray  # int64 [n_edges]
    source_v: np.ndarray  # int64 [n_edges] marker-graph vertex id
    target_v: np.ndarray  # int64 [n_edges]
    is_circular: np.ndarray  # bool [n_edges]

    # Assembled sequence per assembled edge (filled by assemble()).
    seg_rle_offsets: np.ndarray = None  # int64 [n_edges+1]
    seg_rle: np.ndarray = None  # uint8 flat
    seg_rep: np.ndarray = None  # int32 flat
    seg_raw_offsets: np.ndarray = None  # int64 [n_edges+1]
    seg_raw: np.ndarray = None  # uint8 flat

    @property
    def edge_count(self) -> int:
        return self.chain_offsets.shape[0] - 1

    def chain(self, e: int) -> np.ndarray:
        return self.chains[self.chain_offsets[e] : self.chain_offsets[e + 1]]

    def is_assembled_edge(self, e: int) -> bool:
        return e <= self.rc_edge[e]

    def raw_sequence(self, e: int) -> np.ndarray:
        if self.is_assembled_edge(e):
            lo, hi = self.seg_raw_offsets[e], self.seg_raw_offsets[e + 1]
            return self.seg_raw[lo:hi]
        rc = self.rc_edge[e]
        lo, hi = self.seg_raw_offsets[rc], self.seg_raw_offsets[rc + 1]
        s = self.seg_raw[lo:hi]
        return (3 - s[::-1]).astype(np.uint8)

    def arrays(self) -> Dict[str, np.ndarray]:
        out = {
            "chain_offsets": self.chain_offsets,
            "chains": self.chains,
            "rc_edge": self.rc_edge,
            "source_v": self.source_v,
            "target_v": self.target_v,
            "is_circular": self.is_circular,
        }
        for k in ("seg_rle_offsets", "seg_rle", "seg_rep", "seg_raw_offsets", "seg_raw"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out

    @classmethod
    def from_arrays(cls, a) -> "AssemblyGraph":
        return cls(**dict(a))


# Condensations since the last reset (``run_assembly`` resets it when an
# assembly begins, and its performance.log prints it) and the
# marker-graph edges, dead ones included, that they read.
COUNTS = {"condensations": 0, "edges": 0}


def create_assembly_graph(mg: MarkerGraph) -> AssemblyGraph:
    """Condense maximal linear chains of alive marker-graph edges
    (reference: createAssemblyGraphEdges,
    src/AssemblerAssemblyGraph.cpp:38-230) in native code
    (``csrc/assembly_graph.cpp``). RC chains are appended
    immediately after their direct chain, like the reference."""
    with span("stage:graphs.condense"):
        offsets, chains, rc_edge, source_v, target_v, circular = (
            native.condense_chains_native(
                mg.source, mg.target, mg.rc_edge, mg.alive(), mg.vertex_count
            )
        )
    COUNTS["condensations"] += 1
    COUNTS["edges"] += mg.edge_count
    return AssemblyGraph(
        chain_offsets=offsets,
        chains=chains,
        rc_edge=rc_edge,
        source_v=source_v,
        target_v=target_v,
        is_circular=circular,
    )


def chain_mean_coverage(ag: AssemblyGraph, coverage: np.ndarray) -> np.ndarray:
    """Each assembly edge's integer mean of ``coverage`` (the marker-graph
    edges' coverage) over its chain, int64; 0 for an empty chain."""
    lengths = np.diff(ag.chain_offsets)
    full = lengths > 0
    # reduceat over the non-empty chains' starts: each sum runs to the next
    # start, which is its own chain's end.
    sums = np.zeros(lengths.shape[0], np.int64)
    if full.any():
        sums[full] = np.add.reduceat(
            coverage[ag.chains], ag.chain_offsets[:-1][full], dtype=np.int64
        )
    return sums // np.maximum(lengths, 1)


def remove_low_coverage_cross_edges(
    ag: AssemblyGraph, mg: MarkerGraph, threshold: int
) -> int:
    """Remove low-coverage cross edges (reference:
    removeLowCoverageCrossEdges, src/AssemblerAssemblyGraph.cpp:458):
    assembly edges with average coverage <= threshold whose source has
    out-degree > 1 and target in-degree > 1, in increasing coverage
    order; their marker-graph edges get the isLowCoverageCrossEdge
    flag. The caller rebuilds the assembly graph afterwards. Returns
    the number of assembly edges removed."""
    n_e = ag.edge_count
    if n_e == 0 or threshold <= 0:
        return 0
    avg_cov = chain_mean_coverage(ag, mg.coverage)

    removed = np.zeros(n_e, dtype=bool)

    def out_deg(v):
        return int(((ag.source_v == v) & ~removed).sum())

    def in_deg(v):
        return int(((ag.target_v == v) & ~removed).sum())

    count = 0
    order = np.argsort(avg_cov, kind="stable")
    for e in order:
        if avg_cov[e] > threshold:
            break
        if out_deg(ag.source_v[e]) <= 1 or in_deg(ag.target_v[e]) <= 1:
            continue
        removed[e] = True
        mg.low_coverage_cross[ag.chain(e)] = True
        count += 1
    return count


# ---------------------------------------------------------------------------
# Segment stitching
# ---------------------------------------------------------------------------


def assemble_chain(
    mg: MarkerGraph,
    markers: MarkerStore,
    vertex_repeats: np.ndarray,
    edge_consensus: EdgeConsensus,
    chain: np.ndarray,
    kmer_first: Optional[np.ndarray] = None,
    vertex_cov: Optional[np.ndarray] = None,
    with_offsets: bool = False,
):
    """Stitch one marker-graph edge chain into (rle, rep, raw)
    sequence (reference: AssembledSegment::assemble /
    computeVertexOffsets / computeVertexAssembledPortion,
    src/AssembledSegment.cpp:52-180). Shared by mode-0 segment
    assembly, mode-2 branch assembly, and mode-3 path assembly
    (arbitrary paths). With ``with_offsets`` also returns the RLE
    offset of each chain vertex's k-mer in the stitched sequence
    (reference: AssembledSegment::vertexOffsets)."""
    k = markers.k
    if kmer_first is None:
        kmer_first = (
            markers.kmer_ids[mg.vertex_markers[mg.vertex_offsets[:-1]]]
            if mg.vertex_count
            else np.zeros(0, np.uint32)
        )
    if vertex_cov is None:
        vertex_cov = mg.vertex_coverage()

    chain = np.asarray(chain, np.int64)
    n_e = chain.shape[0]
    n_v = n_e + 1
    # Vertices along the chain.
    v_ids = np.empty(n_v, dtype=np.int64)
    v_ids[0] = mg.source[chain[0]]
    v_ids[1:] = mg.target[chain]

    # Per-vertex sequences and repeat counts: all chain vertices
    # unpacked in one bit-shift pass (the per-vertex Python loop was
    # the assemble stage's dominant host cost at scale).
    shifts = (2 * (k - 1 - np.arange(k, dtype=np.int64)))[None, :]
    v_seq_mat = (
        (kmer_first[v_ids].astype(np.int64)[:, None] >> shifts) & 3
    ).astype(np.uint8)
    v_rep_mat = vertex_repeats[v_ids]  # (n_v, k)
    v_cov = vertex_cov[v_ids]

    # Edge fills as CSR slices.
    eoff = edge_consensus.offsets
    e_lo = eoff[chain].astype(np.int64)
    e_len = (eoff[chain + 1] - eoff[chain]).astype(np.int64)
    e_overlap = edge_consensus.overlap[chain].astype(np.int64)

    # Vertex offsets (reference: computeVertexOffsets).
    delta = np.where(e_overlap > 0, k - e_overlap, k + e_len)
    v_off = np.zeros(n_v, dtype=np.int64)
    np.cumsum(delta, out=v_off[1:])

    # Assembled portion per vertex (reference:
    # computeVertexAssembledPortion — overlap resolution by coverage,
    # ties by lower vertex id). The reference scans outward from each
    # vertex until the first out-of-window or beating neighbor; since
    # v_off is nondecreasing, the window is monotone in distance d, so
    # the scans vectorize as one pass per d with undecided masks
    # (window width <= k, so d stays small).
    first = np.zeros(n_v, dtype=np.int64)
    second = np.full(n_v, k, dtype=np.int64)
    undecided = np.ones(n_v, bool)  # backward scan still running
    for d in range(1, n_v):
        i_idx = np.arange(d, n_v)
        j_idx = i_idx - d
        in_win = v_off[j_idx] + k >= v_off[i_idx]
        if not in_win.any():
            break
        act = undecided[d:] & in_win
        if not act.any():
            if not undecided[d:].any():
                break
            undecided[d:] &= in_win
            continue
        beats = (v_cov[j_idx] > v_cov[i_idx]) | (
            (v_cov[j_idx] == v_cov[i_idx]) & (v_ids[j_idx] < v_ids[i_idx])
        )
        hit = act & beats
        ih = i_idx[hit]
        first[ih] = v_off[ih - d] + k - v_off[ih]
        undecided[d:] &= in_win & ~hit
    undecided = np.ones(n_v, bool)  # forward scan
    for d in range(1, n_v):
        i_idx = np.arange(0, n_v - d)
        j_idx = i_idx + d
        in_win = v_off[i_idx] + k >= v_off[j_idx]
        if not in_win.any():
            break
        act = undecided[: n_v - d] & in_win
        if not act.any():
            if not undecided[: n_v - d].any():
                break
            undecided[: n_v - d] &= in_win
            continue
        beats = (v_cov[j_idx] > v_cov[i_idx]) | (
            (v_cov[j_idx] == v_cov[i_idx]) & (v_ids[j_idx] < v_ids[i_idx])
        )
        hit = act & beats
        ih = i_idx[hit]
        second[ih] = v_off[ih + d] - v_off[ih]
        undecided[: n_v - d] &= in_win & ~hit
    bad = second <= first
    first[bad] = 0
    second[bad] = 0

    # Stitch (reference: AssembledSegment::assemble) — one segmented
    # copy into the output, vertex piece i interleaved with edge fill i.
    v_take = second - first
    piece_len = np.zeros(2 * n_v - 1, dtype=np.int64)
    piece_len[0::2] = v_take
    piece_len[1::2] = e_len
    out_off = np.zeros(piece_len.shape[0] + 1, dtype=np.int64)
    np.cumsum(piece_len, out=out_off[1:])
    out_n = int(out_off[-1])
    rle_arr = np.empty(out_n, np.uint8)
    rep_arr = np.empty(out_n, np.int32)
    # Vertex pieces: flat gather from the (n_v, k) matrices.
    tv = int(v_take.sum())
    if tv:
        within = np.arange(tv, dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(v_take)))[:-1], v_take
        )
        src = np.repeat(
            np.arange(n_v, dtype=np.int64) * k + first, v_take
        ) + within
        dst = np.repeat(out_off[0::2][:n_v], v_take) + within
        rle_arr[dst] = v_seq_mat.ravel()[src]
        rep_arr[dst] = v_rep_mat.ravel()[src].astype(np.int32)
    # Edge pieces.
    te = int(e_len.sum())
    if te:
        within_e = np.arange(te, dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(e_len)))[:-1], e_len
        )
        src_e = np.repeat(e_lo, e_len) + within_e
        dst_e = np.repeat(out_off[1::2][:n_e], e_len) + within_e
        rle_arr[dst_e] = edge_consensus.seq[src_e]
        rep_arr[dst_e] = edge_consensus.rep[src_e].astype(np.int32)
    np.maximum(rep_arr, 1, out=rep_arr)
    raw_arr = np.repeat(rle_arr, rep_arr)
    if with_offsets:
        return rle_arr, rep_arr, raw_arr, v_off
    return rle_arr, rep_arr, raw_arr


def assemble_segments(
    ag: AssemblyGraph,
    mg: MarkerGraph,
    markers: MarkerStore,
    vertex_repeats: np.ndarray,  # [n_vertices, k]
    edge_consensus: EdgeConsensus,
) -> None:
    """Stitch each assembled chain into RLE + raw sequence
    (reference: AssembledSegment::assemble/computeVertexOffsets/
    computeVertexAssembledPortion, src/AssembledSegment.cpp:52-180).
    Fills ag.seg_* in place."""
    k = markers.k
    n_a = ag.edge_count
    kmer_first = markers.kmer_ids[mg.vertex_markers[mg.vertex_offsets[:-1]]] if mg.vertex_count else np.zeros(0, np.uint32)
    vertex_cov = mg.vertex_coverage()

    rle_rows: List[np.ndarray] = []
    rep_rows: List[np.ndarray] = []
    raw_rows: List[np.ndarray] = []
    rle_offsets = np.zeros(n_a + 1, dtype=np.int64)
    raw_offsets = np.zeros(n_a + 1, dtype=np.int64)

    for a in range(n_a):
        if not ag.is_assembled_edge(a):
            rle_offsets[a + 1] = rle_offsets[a]
            raw_offsets[a + 1] = raw_offsets[a]
            continue
        chain = ag.chain(a)
        rle_arr, rep_arr, raw_arr = assemble_chain(
            mg, markers, vertex_repeats, edge_consensus, chain,
            kmer_first=kmer_first, vertex_cov=vertex_cov,
        )

        rle_rows.append(rle_arr)
        rep_rows.append(rep_arr)
        raw_rows.append(raw_arr)
        rle_offsets[a + 1] = rle_offsets[a] + rle_arr.shape[0]
        raw_offsets[a + 1] = raw_offsets[a] + raw_arr.shape[0]

    ag.seg_rle_offsets = rle_offsets
    ag.seg_rle = np.concatenate(rle_rows) if rle_rows else np.zeros(0, np.uint8)
    ag.seg_rep = np.concatenate(rep_rows) if rep_rows else np.zeros(0, np.int32)
    ag.seg_raw_offsets = raw_offsets
    ag.seg_raw = np.concatenate(raw_rows) if raw_rows else np.zeros(0, np.uint8)


# ---------------------------------------------------------------------------
# Statistics and writers
# ---------------------------------------------------------------------------


def assembly_statistics(ag: AssemblyGraph) -> Dict[str, int]:
    """Counts + N50 over assembled segments (raw bases), like the
    reference's computeAssemblyStatistics
    (src/AssemblerAssemblyGraph.cpp:864)."""
    lengths = np.diff(ag.seg_raw_offsets)
    lengths = lengths[lengths > 0]
    total = int(lengths.sum())
    n50 = 0
    if total > 0:
        s = np.sort(lengths)[::-1]
        cum = np.cumsum(s)
        n50 = int(s[np.searchsorted(cum, total / 2)])
    return {
        "segment_count": int(lengths.shape[0]),
        "total_length": total,
        "longest": int(lengths.max()) if lengths.shape[0] else 0,
        "n50": n50,
    }


_BASES = np.array(["A", "C", "G", "T"])
_BASES_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def _seq_str(codes: np.ndarray) -> str:
    # Byte-LUT + tobytes: ~100x the per-character str join at the
    # tens-of-MB sizes the GFA/FASTA writers push through here.
    return _BASES_ASCII[codes].tobytes().decode("ascii")


def write_gfa1(
    path: str,
    ag: AssemblyGraph,
    k: int,
    vertex_repeats: Optional[np.ndarray] = None,
    both_strands: bool = False,
) -> None:
    """GFA 1.0 (reference: writeGfa1,
    src/AssemblerAssemblyGraph.cpp:942): S per assembled edge (raw
    sequence), L per (in-edge, out-edge) pair at every vertex, mapped
    to the assembled representative with orientation flips."""
    n = ag.edge_count
    with open(path, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        for e in range(n):
            if not both_strands and not ag.is_assembled_edge(e):
                continue
            s = ag.raw_sequence(e)
            if s.shape[0] == 0:
                continue
            f.write(f"S\t{e}\t{_seq_str(s)}\n")

        # Links: group edges by shared vertex.
        by_target: Dict[int, List[int]] = {}
        by_source: Dict[int, List[int]] = {}
        for e in range(n):
            by_source.setdefault(int(ag.source_v[e]), []).append(e)
            by_target.setdefault(int(ag.target_v[e]), []).append(e)
        # Raw overlap length at a vertex = sum of its k repeat counts.
        for v, ins in by_target.items():
            outs = by_source.get(v)
            if not outs:
                continue
            if vertex_repeats is not None:
                olap = int(vertex_repeats[v].sum())
            else:
                olap = k
            for e0 in ins:
                for e1 in outs:
                    if both_strands:
                        f.write(f"L\t{e0}\t+\t{e1}\t+\t{olap}M\n")
                    else:
                        r0, o0 = (
                            (e0, "+") if ag.is_assembled_edge(e0) else (int(ag.rc_edge[e0]), "-")
                        )
                        r1, o1 = (
                            (e1, "+") if ag.is_assembled_edge(e1) else (int(ag.rc_edge[e1]), "-")
                        )
                        f.write(f"L\t{r0}\t{o0}\t{r1}\t{o1}\t{olap}M\n")


def write_fasta(path: str, ag: AssemblyGraph) -> None:
    """FASTA of assembled segments (reference: writeFasta,
    src/AssemblerAssemblyGraph.cpp:1214)."""
    with open(path, "w") as f:
        for e in range(ag.edge_count):
            if not ag.is_assembled_edge(e):
                continue
            s = ag.raw_sequence(e)
            if s.shape[0] == 0:
                continue
            f.write(f">{e} length {s.shape[0]}\n")
            f.write(_seq_str(s))
            f.write("\n")
