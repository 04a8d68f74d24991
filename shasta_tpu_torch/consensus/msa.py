"""Small multiple sequence alignment for marker-graph edge consensus.

The reference uses spoa partial-order alignment (NW, match 1,
mismatch -1, gap -1) over the distinct intervening sequences of a
marker graph edge, entered in decreasing frequency order
(reference: src/AssemblerMarkerGraph.cpp:3545-3566, scoring at
src/AssemblerMarkerGraph.cpp:4908-4913).

Here we use a center-star MSA with the same scoring: every other
sequence is NW-aligned against the first (most frequent) sequence and
the pairwise alignments are merged column-wise ("once a gap, always a
gap"). For the dominant consensus cases — all sequences equal, or
small indel/substitution variants of the most frequent sequence — this
produces the same consensus columns as POA at a fraction of the
complexity, and it vectorizes: the pairwise NW against the single
center is a batched DP, the same kernel family as the marker
alignment. Exact POA can be swapped in per edge class later without
changing callers.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

GAP = 4


def nw_align(a: np.ndarray, b: np.ndarray, match=1, mismatch=-1, gap=-1):
    """Global NW alignment; returns (a_idx, b_idx) aligned index rows
    where -1 marks a gap. Ties prefer diagonal, then up (consume a),
    then left — matching spoa's move preference."""
    la, lb = a.shape[0], b.shape[0]
    V = np.zeros((la + 1, lb + 1), dtype=np.int32)
    V[:, 0] = gap * np.arange(la + 1)
    V[0, :] = gap * np.arange(lb + 1)
    # Vectorize the inner loop over j.
    for i in range(1, la + 1):
        sub = np.where(b == a[i - 1], match, mismatch)
        row_prev = V[i - 1]
        diag = row_prev[:-1] + sub
        up = row_prev[1:] + gap
        best = np.maximum(diag, up)
        # Left moves need a sequential pass: V[i,j] = max(best[j], V[i,j-1]+gap)
        run = np.maximum.accumulate(best - gap * np.arange(1, lb + 1))
        V[i, 1:] = np.maximum(best, run + gap * np.arange(1, lb + 1))
    # Traceback.
    ai: List[int] = []
    bi: List[int] = []
    i, j = la, lb
    while i > 0 or j > 0:
        if i > 0 and j > 0 and V[i, j] == V[i - 1, j - 1] + (
            match if a[i - 1] == b[j - 1] else mismatch
        ):
            ai.append(i - 1)
            bi.append(j - 1)
            i -= 1
            j -= 1
        elif i > 0 and V[i, j] == V[i - 1, j] + gap:
            ai.append(i - 1)
            bi.append(-1)
            i -= 1
        else:
            ai.append(-1)
            bi.append(j - 1)
            j -= 1
    return np.array(ai[::-1], np.int64), np.array(bi[::-1], np.int64)


def center_star_msa(seqs: List[np.ndarray]) -> List[np.ndarray]:
    """MSA of sequences (uint8 base codes); seqs[0] is the center.

    Returns aligned rows (uint8, value 4 = gap), all equal length.
    """
    n = len(seqs)
    if n == 1:
        return [seqs[0].astype(np.uint8)]
    center = seqs[0]
    lc = center.shape[0]

    # Pairwise alignments against the center. For each, record how many
    # insertions (gaps in the center) occur before each center position.
    pair_rows = []
    ins_before = np.zeros((n - 1, lc + 1), dtype=np.int64)
    for t in range(1, n):
        ai, bi = nw_align(center, seqs[t])
        pair_rows.append((ai, bi))
        # count gap-in-center runs: positions where ai == -1, attributed
        # to the next center index.
        nxt = 0
        run = 0
        for k in range(ai.shape[0]):
            if ai[k] == -1:
                run += 1
            else:
                ins_before[t - 1, ai[k]] = max(ins_before[t - 1, ai[k]], run)
                run = 0
                nxt = ai[k] + 1
        ins_before[t - 1, lc] = max(ins_before[t - 1, lc], run)

    # Merged column layout: before each center position p there are
    # max_ins[p] insertion columns.
    max_ins = ins_before.max(axis=0)
    col_of_center = np.zeros(lc, dtype=np.int64)
    width = 0
    for p in range(lc):
        width += int(max_ins[p])
        col_of_center[p] = width
        width += 1
    width += int(max_ins[lc])

    rows = [np.full(width, GAP, dtype=np.uint8) for _ in range(n)]
    rows[0][col_of_center] = center

    for t in range(1, n):
        ai, bi = pair_rows[t - 1]
        out = rows[t]
        # Walk the pairwise alignment, placing b's characters.
        run = 0
        for k in range(ai.shape[0]):
            if ai[k] == -1:
                # insertion before next center position
                # find next center index
                nxt = lc
                for kk in range(k + 1, ai.shape[0]):
                    if ai[kk] != -1:
                        nxt = int(ai[kk])
                        break
                base_col = col_of_center[nxt] if nxt < lc else width
                col = base_col - (_count_ins_after(ai, k))
                if bi[k] >= 0:
                    out[col] = seqs[t][bi[k]]
            else:
                if bi[k] >= 0:
                    out[col_of_center[ai[k]]] = seqs[t][bi[k]]
    return rows


def _count_ins_after(ai: np.ndarray, k: int) -> int:
    """Number of consecutive insertion steps at/after k until the next
    center-consuming step (including step k)."""
    c = 0
    for kk in range(k, ai.shape[0]):
        if ai[kk] == -1:
            c += 1
        else:
            break
    return c


def poa_msa(seqs: List[np.ndarray]) -> List[np.ndarray]:
    """Partial-order-alignment MSA (the algorithm the reference gets
    from the spoa library, reference: src/AssemblerMarkerGraph.cpp:2001
    -2010 and :3540-3560). Sequences should be ordered by decreasing
    frequency (the reference adds them to the spoa graph in that
    order). Falls back to the center-star approximation when the
    native library is unavailable.

    Returns aligned rows (uint8, value 4 = gap), all equal length.
    """
    n = len(seqs)
    if n == 0:
        return []
    if n == 1:
        return [seqs[0].astype(np.uint8)]
    from shasta_tpu_torch import native

    rows = native.poa_msa_native(seqs)
    if rows is None:
        return center_star_msa(seqs)
    out = []
    for r in rows:
        r = r.copy()
        r[r == 255] = GAP
        out.append(r)
    return out
