"""Small multiple sequence alignment for marker-graph edge consensus.

The reference uses spoa partial-order alignment (NW, match 1,
mismatch -1, gap -1) over the distinct intervening sequences of a
marker graph edge, entered in decreasing frequency order
(reference: src/AssemblerMarkerGraph.cpp:3545-3566, scoring at
src/AssemblerMarkerGraph.cpp:4908-4913). ``poa_msa`` runs the native
library's partial-order alignment (native/poa.cpp); ``nw_align`` is a
global pairwise NW with spoa's move preferences, which mode 2's bubble
pass and iterative assembly use.
"""

from __future__ import annotations

from typing import List

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


def poa_msa(seqs: List[np.ndarray]) -> List[np.ndarray]:
    """Partial-order-alignment MSA (the algorithm the reference gets
    from the spoa library, reference: src/AssemblerMarkerGraph.cpp:2001
    -2010 and :3540-3560). Sequences should be ordered by decreasing
    frequency (the reference adds them to the spoa graph in that
    order). Runs native/poa.cpp through the native library.

    Returns aligned rows (uint8, value 4 = gap), all equal length.
    """
    n = len(seqs)
    if n == 0:
        return []
    if n == 1:
        return [seqs[0].astype(np.uint8)]
    from shasta_tpu_torch import native

    out = []
    for r in native.poa_msa_native(seqs):
        r = r.copy()
        r[r == 255] = GAP
        out.append(r)
    return out
