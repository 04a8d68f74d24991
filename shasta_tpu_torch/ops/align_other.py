"""Alignment methods 0, 1 and 4 (method 3 is the production default,
implemented in shasta_tpu_torch.ops.align / align_kernel).

- Method 0 (reference: src/AlignmentGraph.{hpp,cpp}): the legacy
  alignment. Matching marker pairs ("dots", restricted to markers that
  occur at most maxMarkerFrequency times in each read) are chained
  into the best strictly-increasing path under maxSkip/maxDrift
  constraints. The reference finds this path via a boost Dijkstra over
  a graph of dots; an equivalent heaviest-increasing-chain DP is used
  here (same constraints, same matches-maximizing objective).
- Method 1 (reference: src/AssemblerAlign1.cpp): SeqAn global/overlap
  alignment over the full marker sequences, O(N^2). Implemented as the
  same NW (free-end overlap scoring) on host; intended for short
  sequences and debugging, exactly like the reference.
- Method 4 (reference: src/Align4.{hpp,cpp}): band discovery from
  downsampled matching markers followed by banded alignment. This is
  structurally the two-phase scheme the method-3 engine already
  implements (band from downsampled dots -> banded DP), so method 4
  dispatches to that engine.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def dots_between(
    a: np.ndarray, b: np.ndarray, max_marker_frequency: int = 10
) -> Tuple[np.ndarray, np.ndarray]:
    """All (i, j) with a[i] == b[j], for k-mers occurring at most
    max_marker_frequency times in each sequence; sorted by (i, j)."""
    ua, ca = np.unique(a, return_counts=True)
    ub, cb = np.unique(b, return_counts=True)
    ok_a = set(ua[ca <= max_marker_frequency].tolist())
    ok_b = set(ub[cb <= max_marker_frequency].tolist())
    ok = ok_a & ok_b
    ii = []
    jj = []
    pos_b = {}
    for j, kb in enumerate(b):
        if int(kb) in ok:
            pos_b.setdefault(int(kb), []).append(j)
    for i, ka in enumerate(a):
        for j in pos_b.get(int(ka), ()):
            ii.append(i)
            jj.append(j)
    order = np.lexsort((jj, ii)) if ii else np.zeros(0, np.int64)
    return (
        np.array(ii, np.int64)[order] if ii else np.zeros(0, np.int64),
        np.array(jj, np.int64)[order] if jj else np.zeros(0, np.int64),
    )


def align_method0(
    a: np.ndarray,
    b: np.ndarray,
    max_skip: int = 30,
    max_drift: int = 30,
    max_marker_frequency: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Heaviest strictly-increasing chain of matching marker dots
    under skip/drift constraints. Returns (ord0, ord1)."""
    ii, jj = dots_between(a, b, max_marker_frequency)
    n = ii.shape[0]
    if n == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32)
    best = np.ones(n, np.int64)
    prev = np.full(n, -1, np.int64)
    for t in range(n):
        for s in range(t - 1, -1, -1):
            if ii[t] - ii[s] > max_skip:
                break  # sorted by i: no earlier dot can be closer
            if ii[s] >= ii[t] or jj[s] >= jj[t]:
                continue
            if jj[t] - jj[s] > max_skip:
                continue
            drift = abs((ii[t] - jj[t]) - (ii[s] - jj[s]))
            if drift > max_drift:
                continue
            if best[s] + 1 > best[t]:
                best[t] = best[s] + 1
                prev[t] = s
    end = int(np.argmax(best))
    path = []
    while end >= 0:
        path.append(end)
        end = int(prev[end])
    path.reverse()
    return ii[path].astype(np.uint32), jj[path].astype(np.uint32)


def align_candidates_method(
    markers,
    read_id0: np.ndarray,
    read_id1: np.ndarray,
    same_strand: np.ndarray,
    params,
    method: int,
    max_marker_frequency: int = 10,
):
    """Align candidates with method 0 or 1 and apply the reference's
    acceptance filters; returns an AlignmentStore (host loop — these
    methods exist for parity/debugging, the production path is the
    batched method 3 engine)."""
    from shasta_tpu_torch.ops.align import AlignmentStore, _metrics_from_ordinals

    koff = markers.offsets
    kmer_flat = markers.kmer_ids.astype(np.int32)
    or0 = read_id0.astype(np.int64) << 1
    or1 = (read_id1.astype(np.int64) << 1) | (~same_strand).astype(np.int64)

    keep_rows = []
    for p in range(read_id0.shape[0]):
        a = kmer_flat[koff[or0[p]] : koff[or0[p] + 1]]
        b = kmer_flat[koff[or1[p]] : koff[or1[p] + 1]]
        if method == 0:
            o0, o1 = align_method0(
                a, b, max_skip=params.max_skip, max_drift=params.max_drift,
                max_marker_frequency=max_marker_frequency,
            )
        else:
            o0, o1 = align_method1(
                a, b, params.match_score, params.mismatch_score, params.gap_score
            )
        mc = o0.shape[0]
        if mc < params.min_aligned_marker_count:
            continue
        n0, n1 = a.shape[0], b.shape[0]
        first0, last0 = int(o0[0]), int(o0[-1])
        first1, last1 = int(o1[0]), int(o1[-1])
        if (
            min(mc / (last0 + 1 - first0), mc / (last1 + 1 - first1))
            < params.min_aligned_fraction
        ):
            continue
        if (
            min(first0, first1) > params.max_trim
            or min(n0 - 1 - last0, n1 - 1 - last1) > params.max_trim
        ):
            continue
        if getattr(params, "suppress_containments", False) and (
            (first0 <= params.max_trim and n0 - 1 - last0 <= params.max_trim)
            or (first1 <= params.max_trim and n1 - 1 - last1 <= params.max_trim)
        ):
            continue
        max_skip, max_drift, omin, omax = _metrics_from_ordinals(o0, o1)
        if max_skip > params.max_skip or max_drift > params.max_drift:
            continue
        keep_rows.append(
            (p, mc, n0, n1, first0, last0, first1, last1, omin, omax,
             max_skip, max_drift, o0, o1)
        )

    n_keep = len(keep_rows)
    offs = np.zeros(n_keep + 1, np.int64)
    for i, row in enumerate(keep_rows):
        offs[i + 1] = offs[i] + row[1]
    ord0 = np.empty(int(offs[-1]), np.uint32)
    ord1 = np.empty(int(offs[-1]), np.uint32)
    for i, row in enumerate(keep_rows):
        ord0[offs[i] : offs[i + 1]] = row[12]
        ord1[offs[i] : offs[i + 1]] = row[13]

    def col(j, dtype=np.int32):
        return np.array([r[j] for r in keep_rows], dtype)

    kept_p = col(0, np.int64)
    return AlignmentStore(
        read_id0=read_id0[kept_p].astype(np.int32),
        read_id1=read_id1[kept_p].astype(np.int32),
        same_strand=same_strand[kept_p].astype(bool),
        marker_count=col(1),
        n_markers0=col(2),
        n_markers1=col(3),
        first0=col(4),
        last0=col(5),
        first1=col(6),
        last1=col(7),
        min_offset=col(8),
        max_offset=col(9),
        max_skip_v=col(10),
        max_drift_v=col(11),
        ord0=ord0,
        ord1=ord1,
        offsets=offs,
    )


def align_method1(
    a: np.ndarray, b: np.ndarray, match: int = 6, mismatch: int = -1, gap: int = -1
) -> Tuple[np.ndarray, np.ndarray]:
    """Full (unbanded) overlap alignment over marker sequences;
    returns matched ordinal pairs on the optimal path."""
    from shasta_tpu_torch.consensus.msa import nw_align

    # nw_align is global NW with the same move preferences; free-end
    # behavior is approximated by trimming end gaps from the result.
    a0, b0 = nw_align(a.astype(np.int64), b.astype(np.int64), match, mismatch, gap)
    o0 = []
    o1 = []
    for i, j in zip(a0, b0):
        if i >= 0 and j >= 0 and a[i] == b[j]:
            o0.append(i)
            o1.append(j)
    return np.array(o0, np.uint32), np.array(o1, np.uint32)


# ---------------------------------------------------------------------------
# Alignment method 4 (sparse cell analysis + banded alignment)
# ---------------------------------------------------------------------------


def align4_bands(
    a: np.ndarray,
    b: np.ndarray,
    delta_x: int = 200,
    delta_y: int = 10,
    min_entry_count: int = 10,
    max_distance_from_boundary: int = 100,
):
    """Band candidates via method 4's sparse cell analysis
    (reference: src/Align4.{hpp,cpp}).

    The sparse alignment matrix (marker matches) is expressed in
    rotated coordinates X = x + y, Y = y + (nx-1-x) and binned into
    (deltaX, deltaY) cells; well-populated cells that are both
    forward-accessible from the left/top boundary and
    backward-accessible from the right/bottom are grouped into
    8-connected components, each contributing one band
    [nx-1-Ymax, nx-1-Ymin] (Align4.cpp:872-940).

    Returns a list of (band_min, band_max) on offset x - y.
    """
    nx, ny = a.shape[0], b.shape[0]
    if nx == 0 or ny == 0:
        return []

    # All marker matches (x, y): sort both sides, expand per common kmer.
    ia = np.argsort(a, kind="stable")
    ib = np.argsort(b, kind="stable")
    sa, sb = a[ia], b[ib]
    common = np.intersect1d(sa, sb)
    if common.shape[0] == 0:
        return []
    la = np.searchsorted(sa, common, side="left")
    ha = np.searchsorted(sa, common, side="right")
    lb = np.searchsorted(sb, common, side="left")
    hb = np.searchsorted(sb, common, side="right")
    na_, nb_ = ha - la, hb - lb
    n_pairs = na_ * nb_
    total = int(n_pairs.sum())
    if total == 0:
        return []
    k_of = np.repeat(np.arange(common.shape[0]), n_pairs)
    t = np.arange(total) - np.repeat(
        np.concatenate(([0], np.cumsum(n_pairs)))[:-1], n_pairs
    )
    x = ia[la[k_of] + t // nb_[k_of]].astype(np.int64)
    y = ib[lb[k_of] + t % nb_[k_of]].astype(np.int64)

    X = x + y
    Y = y + (nx - 1 - x)
    iX = X // delta_x
    iY = Y // delta_y

    # Well-populated cells.
    stride = int(iX.max()) + 2
    key = iY * stride + iX
    cell_keys, counts = np.unique(key, return_counts=True)
    cell_keys = cell_keys[counts >= min_entry_count]
    if cell_keys.shape[0] == 0:
        return []
    ciY, ciX = cell_keys // stride, cell_keys % stride

    def xy_of(Xc, Yc):
        # C++ truncating division (Align4.cpp:184-191).
        xs = np.trunc((Xc - Yc + nx - 1) / 2).astype(np.int64)
        ys = np.trunc((Xc + Yc - nx + 1) / 2).astype(np.int64)
        return xs, ys

    d = max_distance_from_boundary
    xl, _ = xy_of(ciX * delta_x, (ciY + 1) * delta_y)  # bottom left
    _, yt = xy_of(ciX * delta_x, ciY * delta_y)  # top left
    xr, _ = xy_of((ciX + 1) * delta_x, ciY * delta_y)  # top right
    _, yb = xy_of((ciX + 1) * delta_x, (ciY + 1) * delta_y)  # bottom right
    near_lt = (np.maximum(xl, 0) < d) | (np.maximum(yt, 0) < d)
    near_rb = (np.where(xr >= nx - 1, 0, nx - 1 - xr) < d) | (
        np.where(yb >= ny - 1, 0, ny - 1 - yb) < d
    )

    cells = {(int(cx), int(cy)): i for i, (cx, cy) in enumerate(zip(ciX, ciY))}
    n_cells = len(cells)

    # Forward DFS (children at dX in {0,1}, dY in {-1,0,1}).
    fwd = np.zeros(n_cells, bool)
    stack = [i for i in range(n_cells) if near_lt[i]]
    fwd[stack] = True
    while stack:
        i = stack.pop()
        cx, cy = int(ciX[i]), int(ciY[i])
        for dy in (-1, 0, 1):
            for dx in (0, 1):
                j = cells.get((cx + dx, cy + dy))
                if j is not None and not fwd[j]:
                    fwd[j] = True
                    stack.append(j)

    # Backward DFS (parents at dX in {-1,0}), seeded from cells near
    # the right/bottom that are also forward accessible.
    bwd = np.zeros(n_cells, bool)
    stack = [i for i in range(n_cells) if near_rb[i] and fwd[i]]
    bwd[stack] = True
    while stack:
        i = stack.pop()
        cx, cy = int(ciX[i]), int(ciY[i])
        for dy in (-1, 0, 1):
            for dx in (-1, 0):
                j = cells.get((cx + dx, cy + dy))
                if j is not None and not bwd[j]:
                    bwd[j] = True
                    stack.append(j)

    active = fwd & bwd
    if not active.any():
        return []

    # 8-connected components of active cells.
    comp = {i: i for i in range(n_cells) if active[i]}

    def find(i):
        while comp[i] != i:
            comp[i] = comp[comp[i]]
            i = comp[i]
        return i

    for i in list(comp):
        cx, cy = int(ciX[i]), int(ciY[i])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                j = cells.get((cx + dx, cy + dy))
                if j is not None and j in comp:
                    ri, rj = find(i), find(j)
                    if ri != rj:
                        comp[max(ri, rj)] = min(ri, rj)

    groups = {}
    for i in comp:
        groups.setdefault(find(i), []).append(i)

    bands = []
    for members in groups.values():
        iy = ciY[members]
        y_min = int(iy.min()) * delta_y
        y_max = (int(iy.max()) + 1) * delta_y - 1
        bands.append((nx - 1 - y_max, nx - 1 - y_min))
    bands.sort()
    return bands


def align_candidates_method4(
    markers,
    read_id0: np.ndarray,
    read_id1: np.ndarray,
    same_strand: np.ndarray,
    params,
    delta_x: int = 200,
    delta_y: int = 10,
    min_entry_count: int = 10,
    max_distance_from_boundary: int = 100,
    device="cuda",
):
    """Method-4 alignment of candidate pairs: sparse cell analysis
    finds one band per active-cell component; each band runs the
    batched banded DP kernel; the best passing alignment per pair (by
    marker count) is kept (reference: Align4.cpp:46-150).

    ``device`` is where the DP runs: "cuda" (the kernels) unless the
    caller asks for "cpu" (the plain version).
    """
    from shasta_tpu_torch.ops.align import (
        AlignmentStore,
        _grouped_run,
    )
    from shasta_tpu_torch.ops.align_kernel import resolve_device

    device = resolve_device(device)

    koff = markers.offsets
    kmer_flat = markers.kmer_ids.astype(np.int32)
    or0 = read_id0.astype(np.int64) << 1
    or1 = (read_id1.astype(np.int64) << 1) | (~same_strand).astype(np.int64)
    n_pairs = read_id0.shape[0]

    tasks = []  # (pair index, band_min, band_max)
    a_rows, b_rows, bmins, widths = [], [], [], []
    for p in range(n_pairs):
        a = kmer_flat[koff[or0[p]] : koff[or0[p] + 1]]
        b = kmer_flat[koff[or1[p]] : koff[or1[p] + 1]]
        for band_min, band_max in align4_bands(
            a, b, delta_x, delta_y, min_entry_count, max_distance_from_boundary
        ):
            if band_max - band_min + 1 > params.max_band:
                continue  # Align4.cpp:929-935
            tasks.append(p)
            a_rows.append(a)
            b_rows.append(b)
            # Kernel band is on j - i = y - x = -offset.
            bmins.append(-band_max)
            widths.append(band_max - band_min + 1)

    rows = {}  # pair -> best (metrics, ord0, ord1)
    if tasks:
        results, metrics = _grouped_run(
            a_rows, b_rows,
            np.asarray(bmins, np.int64), np.asarray(widths, np.int64), params,
            device=device,
        )
        for t, p in enumerate(tasks):
            o0, o1 = results[t]
            mc = int(metrics[t, 0])
            if mc < params.min_aligned_marker_count:
                continue
            n0, n1 = a_rows[t].shape[0], b_rows[t].shape[0]
            first0, last0 = int(metrics[t, 1]), int(metrics[t, 2])
            first1, last1 = int(metrics[t, 3]), int(metrics[t, 4])
            frac = min(
                mc / max(1, last0 + 1 - first0), mc / max(1, last1 + 1 - first1)
            )
            if frac < params.min_aligned_fraction:
                continue
            if int(metrics[t, 7]) > params.max_skip:
                continue
            if int(metrics[t, 8]) > params.max_drift:
                continue
            if min(first0, first1) > params.max_trim:
                continue
            if min(n0 - 1 - last0, n1 - 1 - last1) > params.max_trim:
                continue
            prev = rows.get(p)
            if prev is None or mc > prev[0][0]:
                rows[p] = (
                    [mc, first0, last0, first1, last1,
                     int(metrics[t, 5]), int(metrics[t, 6]),
                     int(metrics[t, 7]), int(metrics[t, 8]), n0, n1],
                    o0, o1,
                )

    kept = sorted(rows)
    offs = np.zeros(len(kept) + 1, np.int64)
    for i, p in enumerate(kept):
        offs[i + 1] = offs[i] + rows[p][1].shape[0]
    ord0 = np.empty(int(offs[-1]), np.uint32)
    ord1 = np.empty(int(offs[-1]), np.uint32)
    for i, p in enumerate(kept):
        ord0[offs[i] : offs[i + 1]] = rows[p][1]
        ord1[offs[i] : offs[i + 1]] = rows[p][2]
    m = np.array([rows[p][0] for p in kept], np.int64).reshape(len(kept), 11)
    kp = np.asarray(kept, np.int64)
    return AlignmentStore(
        read_id0=read_id0[kp].astype(np.int32),
        read_id1=read_id1[kp].astype(np.int32),
        same_strand=same_strand[kp].astype(bool),
        marker_count=m[:, 0].astype(np.int32),
        n_markers0=m[:, 9].astype(np.int32),
        n_markers1=m[:, 10].astype(np.int32),
        first0=m[:, 1].astype(np.int32),
        last0=m[:, 2].astype(np.int32),
        first1=m[:, 3].astype(np.int32),
        last1=m[:, 4].astype(np.int32),
        min_offset=m[:, 5].astype(np.int32),
        max_offset=m[:, 6].astype(np.int32),
        max_skip_v=m[:, 7].astype(np.int32),
        max_drift_v=m[:, 8].astype(np.int32),
        ord0=ord0,
        ord1=ord1,
        offsets=offs,
    )
