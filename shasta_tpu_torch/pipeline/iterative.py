"""Iterative assembly: refine the read graph using pseudo-paths.

Counterpart of the reference's iterative assembly option
(reference: srcMain/main.cpp:851-906,
src/AssemblerCreateReadGraphUsingPseudoPaths.cpp): after an initial
assembly, each oriented read's *pseudo-path* (its journey through the
assembly graph segments — the same object mode 3 calls a journey) is
computed; each alignment's two pseudo-paths are aligned (NW over
segment ids, match 1 / mismatch -1 / gap -1); alignments whose
pseudo-paths disagree are dropped (score threshold with a quadratic
mismatch penalty, reference's mismatchSquareFactor); the read graph is
rebuilt from the survivors and the marker graph is recomputed. Repeat.

This separates reads from different repeat copies / haplotypes that
sequence-level alignment alone cannot distinguish.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from shasta_tpu_torch.consensus.msa import nw_align
from shasta_tpu_torch.graph import marker_graph as MG
from shasta_tpu_torch.graph import read_graph as RG
from shasta_tpu_torch.graph.mode3 import create_mode3_graph


def score_alignment_pseudo_paths(
    journey0: np.ndarray,
    journey1: np.ndarray,
    mismatch_square_factor: float = 3.0,
    match_score: int = 1,
    mismatch_score: int = -1,
    gap_score: int = -1,
) -> float:
    """Alignment score of two pseudo-paths (reference semantics:
    match 1, mismatch -1, gap -1, final score penalized by
    mismatchSquareFactor * mismatches^2)."""
    if journey0.shape[0] == 0 or journey1.shape[0] == 0:
        return 0.0
    a0, a1 = nw_align(
        journey0.astype(np.int64), journey1.astype(np.int64),
        match_score, mismatch_score, gap_score,
    )
    matches = 0
    mismatches = 0
    for i, j in zip(a0, a1):
        if i >= 0 and j >= 0:
            if journey0[i] == journey1[j]:
                matches += 1
            else:
                mismatches += 1
    return matches - mismatch_square_factor * mismatches * mismatches


def nw_match_mismatch_batch(
    a_pad: np.ndarray,
    a_len: np.ndarray,
    b_pad: np.ndarray,
    b_len: np.ndarray,
    match: int = 1,
    mismatch: int = -1,
    gap: int = -1,
) -> Tuple[np.ndarray, np.ndarray]:
    """(matches, mismatches) on the optimal global-NW path for a batch
    of padded int sequences — the batched form of
    :func:`shasta_tpu_torch.consensus.msa.nw_align` with IDENTICAL
    tie-breaking (diagonal, then up, then left), vectorized over the
    batch in plain numpy (journeys are tens of segments, so the full
    (B, L0+1, L1+1) DP is small; the reference threads this loop,
    src/AssemblerCreateReadGraphUsingPseudoPaths.cpp)."""
    B, L0 = a_pad.shape
    L1 = b_pad.shape[1]
    V = np.zeros((B, L0 + 1, L1 + 1), np.int32)
    V[:, :, 0] = gap * np.arange(L0 + 1, dtype=np.int32)[None, :]
    V[:, 0, :] = gap * np.arange(L1 + 1, dtype=np.int32)[None, :]
    jj = np.arange(1, L1 + 1, dtype=np.int32)[None, :]
    for i in range(1, L0 + 1):
        sub = np.where(b_pad == a_pad[:, i - 1 : i], match, mismatch)
        row_prev = V[:, i - 1]
        diag = row_prev[:, :-1] + sub
        up = row_prev[:, 1:] + gap
        best = np.maximum(diag, up)
        run = np.maximum.accumulate(best - gap * jj, axis=1)
        V[:, i, 1:] = np.maximum(best, run + gap * jj)
    # Vectorized traceback: every pair walks from (a_len, b_len); the
    # same move-preference checks as nw_align, batched.
    bi = np.arange(B)
    i = a_len.astype(np.int64).copy()
    j = b_len.astype(np.int64).copy()
    m_cnt = np.zeros(B, np.int64)
    x_cnt = np.zeros(B, np.int64)
    for _ in range(L0 + L1):
        active = (i > 0) | (j > 0)
        if not active.any():
            break
        ic = np.maximum(i, 1)
        jc = np.maximum(j, 1)
        av = a_pad[bi, ic - 1]
        bv = b_pad[bi, jc - 1]
        eq = av == bv
        sub = np.where(eq, match, mismatch)
        vij = V[bi, i, j]
        can_diag = (
            (i > 0) & (j > 0) & (vij == V[bi, ic - 1, jc - 1] + sub)
        )
        can_up = (i > 0) & (vij == V[bi, ic - 1, j] + gap)
        take_diag = active & can_diag
        take_up = active & ~can_diag & can_up
        take_left = active & ~can_diag & ~can_up
        m_cnt += take_diag & eq
        x_cnt += take_diag & ~eq
        i -= take_diag | take_up
        j -= take_diag | take_left
    return m_cnt, x_cnt


_NW_LEN_BUCKETS = (8, 16, 32, 64, 128, 256, 512)
# Cap the per-chunk DP memory: B * (L+1)^2 int32 cells.
_NW_CELL_BUDGET = 1 << 26


def score_pseudo_path_batch(
    flat: np.ndarray,
    off: np.ndarray,
    orid0: np.ndarray,
    orid1: np.ndarray,
    mismatch_square_factor: float,
    match: int = 1,
    mismatch: int = -1,
    gap: int = -1,
) -> np.ndarray:
    """Pseudo-path alignment scores for alignment pairs, batched.

    flat/off: CSR of per-oriented-read journeys (segment ids);
    orid0/orid1: the pair's oriented reads. Returns (n,) float64
    scores = matches - mismatch_square_factor * mismatches^2 (pairs
    with an empty journey score 0, like the loop form)."""
    lens = np.diff(off)
    l0 = lens[orid0].astype(np.int64)
    l1 = lens[orid1].astype(np.int64)
    n = orid0.shape[0]
    scores = np.zeros(n, np.float64)
    live = np.flatnonzero((l0 > 0) & (l1 > 0))
    if live.shape[0] == 0:
        return scores
    key = np.maximum(
        _bucket_len(l0[live]), _bucket_len(l1[live])
    )
    for L in np.unique(key):
        sel = live[key == L]
        step = max(int(_NW_CELL_BUDGET // ((L + 1) * (L + 1))), 64)
        for lo in range(0, sel.shape[0], step):
            s = sel[lo : lo + step]
            a_pad = _pad_journeys(flat, off, orid0[s], l0[s], int(L), -1)
            b_pad = _pad_journeys(flat, off, orid1[s], l1[s], int(L), -2)
            m, x = nw_match_mismatch_batch(
                a_pad, l0[s], b_pad, l1[s], match, mismatch, gap
            )
            scores[s] = m - mismatch_square_factor * x.astype(np.float64) ** 2
    return scores


def _bucket_len(n: np.ndarray) -> np.ndarray:
    b = np.asarray(_NW_LEN_BUCKETS, np.int64)
    idx = np.minimum(np.searchsorted(b, n), len(b) - 1)
    out = b[idx]
    over = n > b[-1]
    if over.any():
        out = out.copy()
        out[over] = 1 << np.ceil(np.log2(n[over])).astype(np.int64)
    return out


def _pad_journeys(flat, off, orids, lens, L, fill):
    ar = np.arange(L, dtype=np.int64)[None, :]
    idx = off[orids][:, None] + ar
    valid = ar < lens[:, None]
    np.minimum(idx, max(flat.shape[0] - 1, 0), out=idx)
    if flat.shape[0] == 0:
        return np.full((orids.shape[0], L), fill, np.int64)
    return np.where(valid, flat[idx], fill)


def refine_read_graph_with_pseudo_paths(
    assembler,
    min_score: float = 1.0,
    mismatch_square_factor: float = 3.0,
) -> Tuple[int, int]:
    """One refinement round: compute journeys from the current marker
    graph, drop read-graph alignments with discordant pseudo-paths,
    rebuild read graph + marker graph. Returns (kept, dropped)."""
    mg = assembler.marker_graph
    markers = assembler.markers
    al = assembler.alignments
    m3 = create_mode3_graph(markers, mg, min_link_coverage=1)

    # Score every alignment's pseudo-path pair in one batched pass.
    n = al.count
    aopt = assembler.config.assembly
    orid0 = al.read_id0.astype(np.int64) * 2
    orid1 = al.read_id1.astype(np.int64) * 2 + np.where(
        al.same_strand, 0, 1
    )
    scores = score_pseudo_path_batch(
        m3.journey_segments, m3.journey_offsets, orid0, orid1,
        mismatch_square_factor,
        aopt.iterative_pseudo_path_align_match_score,
        aopt.iterative_pseudo_path_align_mismatch_score,
        aopt.iterative_pseudo_path_align_gap_score,
    )
    keep = scores >= min_score

    dropped = int((~keep).sum())

    # Rebuild the read graph from surviving alignments with the usual
    # kNN selection restricted to the survivors.
    sub = np.flatnonzero(keep)
    knn_keep = RG.select_alignments_knn(
        _subset_alignments(al, sub), assembler.reads.read_count,
        assembler.config.assembly.iterative_max_alignment_count,
    )
    final_keep = np.zeros(n, dtype=bool)
    final_keep[sub[knn_keep]] = True
    assembler.read_graph = RG.build_read_graph(
        al, assembler.reads.read_count, final_keep
    )

    # Recompute marker graph vertices + edges.
    assembler.create_marker_graph_vertices()
    assembler.create_marker_graph_edges()
    return int(final_keep.sum()), dropped


def _subset_alignments(al, idx: np.ndarray):
    """A lightweight view with only the fields kNN selection needs."""

    class _View:
        pass

    v = _View()
    v.count = idx.shape[0]
    v.read_id0 = al.read_id0[idx]
    v.read_id1 = al.read_id1[idx]
    v.marker_count = al.marker_count[idx]
    return v
