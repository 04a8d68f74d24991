"""banded_fwd's row-scan body (csrc/banded_align.cu): its dead lanes,
live lanes and order of work, on the CPU.

The body computes only the live lanes of a row (the matrix and one
margin column, 0 <= j <= b_len + 1) and writes every other lane of a
processed row as the dead-lane code the scores fix. The tests hold the
plain version (``banded_fwd_plain``, the body's reference on the card)
to that claim and to the JAX package's jnp oracle, check the host
helpers that give the live lanes and the in-matrix cells against
brute-force masks, and follow the body's order of work in numpy
(``model_rows``: columns as lanes, the warps' deferred edge terms, the
blocks of a cluster, strips, the d-word gather) against the plain
version. Every comparison is exact integer equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import shasta_tpu.ops.align as A
from shasta_tpu_torch.ops import align_kernel as K
from tests.torch_common import (  # noqa: F401
    edge_batch, full_matrix_batch, gap_batch, make_batch, mixed_batch, one_torch_thread,
)

NEG = K.NEG_INF
SCORES = {
    "6/-1/-1": dict(match=6, mismatch=-1, gap=-1),
    "6/0/-1": dict(match=6, mismatch=0, gap=-1),
    "6/-1/-2": dict(match=6, mismatch=-1, gap=-2),
}


BATCHES = {
    "full-32x128": lambda: (full_matrix_batch(32, 128), 32, 128),
    "full-40x200-lb100": lambda: (full_matrix_batch(40, 200, LB=100, seed=6), 40, 200),
    "edge": lambda: (edge_batch(128, 288), 128, 288),
    "gap": lambda: (gap_batch(256, 128), 256, 128),
    "mixed": lambda: (mixed_batch(64, 160), 64, 160),
    "LA1": lambda: (make_batch(3, B=6, LA=1, LB=1, W=64), 1, 64),
    "LA17": lambda: (make_batch(4, B=6, LA=17, LB=17, W=96), 17, 96),
}


def prepared(batch, LA, W):
    a, a_len, b, b_len, bm = (torch.from_numpy(x) for x in batch)
    return K.prepare_inputs(a, a_len, b, b_len, bm, LA=LA, LB=b.shape[1], W=W)


def unpack(dirs, LA):
    """(B, ceil(LA / 16), W) packed words -> (B, LA, W) codes."""
    w = dirs.to(torch.int64) & 0xFFFFFFFF
    r = torch.arange(LA)
    return ((w[:, r // 16, :] >> (2 * (r % 16))[None, :, None]) & 3).numpy()


def columns(a_len, band_min, LA, W):
    """(B, LA, W) column j of each lane, and (B, LA) processed rows."""
    i = np.arange(1, LA + 1)[None, :, None]
    j = band_min.numpy()[:, None, None] + i + np.arange(W)[None, None, :]
    return j, (np.arange(1, LA + 1)[None, :] <= a_len.numpy()[:, None])


@pytest.mark.parametrize("scores", list(SCORES))
@pytest.mark.parametrize("batch", list(BATCHES))
def test_dead_lanes_carry_the_dead_code(batch, scores):
    """On every processed row of banded_fwd_plain, every lane outside
    0 <= j <= b_len + 1 carries dead_lane_code(scores): the code the
    row-scan body writes there without computing the cell."""
    host, LA, W = BATCHES[batch]()
    kw = SCORES[scores]
    a, a_len, b, b_len, bm = prepared(host, LA, W)
    dirs, *_ = K.banded_fwd_plain(a, a_len, b, b_len, bm, LA=LA, LB=b.shape[1], W=W, **kw)
    codes = unpack(dirs, LA)
    j, processed = columns(a_len, bm, LA, W)
    dead = ((j < 0) | (j > b_len.numpy()[:, None, None] + 1)) & processed[:, :, None]
    assert dead.any()
    assert (codes[dead] == K.dead_lane_code(**kw)).all()


@pytest.mark.parametrize("scores,code", [("6/-1/-1", 3), ("6/0/-1", 1), ("6/-1/-2", 3)])
def test_dead_lane_code_by_scores(scores, code):
    """LEFT (3) while both neighbours' terms lie below NEG_INF (mismatch
    and gap negative), DIAG without a match (1) at mismatch 0, where the
    base from DIAG is NEG_INF itself."""
    assert K.dead_lane_code(**SCORES[scores]) == code


@pytest.mark.parametrize("batch", list(BATCHES))
def test_live_lanes_and_in_matrix_cells_equal_brute_force(batch):
    """live_lanes gives each processed row's lanes with 0 <= j <= b_len + 1
    (none on other rows), in_matrix_cells the count of processed cells
    with 0 <= j <= b_len: both equal a brute-force mask over the band."""
    host, LA, W = BATCHES[batch]()
    a, a_len, b, b_len, bm = prepared(host, LA, W)
    lo, hi = K.live_lanes(a_len, b_len, bm, LA=LA, W=W)
    j, processed = columns(a_len, bm, LA, W)
    bl = b_len.numpy()[:, None, None]
    d = np.arange(W)[None, None, :]
    live = (j >= 0) & (j <= bl + 1) & processed[:, :, None]
    got = (d >= lo.numpy()[:, :, None]) & (d <= hi.numpy()[:, :, None])
    assert np.array_equal(got, live)
    inside = (j >= 0) & (j <= bl) & processed[:, :, None]
    assert K.in_matrix_cells(a_len, b_len, bm, LA=LA, W=W) == int(inside.sum())
    assert K.in_matrix_cells(a_len, b_len, bm, LA=LA, W=W, chunk=7) == int(inside.sum())


@pytest.mark.parametrize("scores", list(SCORES))
@pytest.mark.parametrize("batch", ["full-32x128", "full-40x200-lb100", "edge", "LA17"])
def test_plain_matches_jnp_oracle(batch, scores):
    """The plain version against shasta_tpu/ops/align.py's jnp oracle on
    the clamped inputs: each cell's direction (DIAG, UP or LEFT) wherever
    the oracle does not stop, the best score, and the traceback's
    matched pairs."""
    host, LA, W = BATCHES[batch]()
    kw = SCORES[scores]
    a, a_len, b, b_len, bm = prepared(host, LA, W)
    LB = b.shape[1]
    dirs, best, bi, bd = K.banded_fwd_plain(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W, **kw)
    mj = K.banded_tb_plain(dirs, bi, bd, bm, LA=LA, W=W).numpy()
    an, aln, bn, bln, bmn = (x.numpy() for x in (a, a_len, b, b_len, bm))
    odirs, obi, obd, obest = A.banded_forward(
        jnp.asarray(an), jnp.asarray(aln), jnp.asarray(bn), jnp.asarray(bln),
        jnp.asarray(bmn), W=W, **kw,
    )
    m0, m1 = A.traceback(odirs, jnp.asarray(an), jnp.asarray(bn), jnp.asarray(bmn),
                         obi, obd, n_steps=LA + LB)
    odirs, m0, m1 = np.asarray(odirs), np.asarray(m0), np.asarray(m1)
    assert np.array_equal(best.numpy(), np.asarray(obest))
    codes = unpack(dirs, LA)
    moving = odirs != A.STOP
    want = np.where(odirs == A.DIAG, 0, odirs)  # DIAG with or without a match
    got = np.where(codes <= K.D_MISMATCH, 0, codes)
    assert moving.any() and np.array_equal(got[moving], want[moving])
    for t in range(an.shape[0]):
        o0 = np.flatnonzero(mj[t] >= 0)
        r0 = m0[m0[:, t] >= 0, t][::-1]
        r1 = m1[m1[:, t] >= 0, t][::-1]
        assert np.array_equal(o0, r0) and np.array_equal(mj[t, o0], r1), t


# ---------------------------------------------------------------------------
# The row-scan body's order of work
# ---------------------------------------------------------------------------


def model_rows(a, a_len, b, b_len, band_min, *, LA, LB, W, match, mismatch, gap,
               C=1, T=32, kc=None):
    """banded_fwd_rows_cluster_kernel (or, with kc=None, the warp tier's
    banded_fwd_rows_warp_kernel: one warp, ceil(window / 32) columns a
    lane) for each pair, in plain Python: columns [cw0, cw1] held by
    C blocks of T threads of kc columns, in strips of C*T*kc columns;
    pass 1 (bases, the running prefix max, the warp's inclusive scan,
    its total with the next warp's first DIAG term, its last column's
    V), the barrier, pass 2 (the carry from earlier warps' totals, the
    first column's DIAG fixed after the barrier, V, codes, end cells),
    the strip's edges, and each 16-row group's d-words gathered from the
    staged j-words one row later. Returns (dirs, best, bi, bd) as
    banded_fwd_plain does, dirs written only on processed words."""
    B = a.shape[0]
    nw16 = (LA + 15) // 16
    dirs = np.zeros((B, nw16, W), np.int64)
    best = np.zeros(B, np.int64)
    bi = np.zeros(B, np.int64)
    bd = np.zeros(B, np.int64)
    dead = K.dead_lane_code(match, mismatch, gap)

    def better(v1, i1, d1, v2, i2, d2):
        return v1 > v2 or (v1 == v2 and (i1 < i2 or (i1 == i2 and d1 < d2)))

    for p in range(B):
        alen, blen, bm = int(a_len[p]), int(b_len[p]), int(band_min[p])
        rows = min(alen, LA)
        cw0 = max(0, bm)
        cw1 = min(blen + 1, rows + bm + W - 1) if rows > 0 else cw0 - 1
        span = max(0, cw1 - cw0 + 1)
        kcp, Tp, Cp = (kc, T, C) if kc is not None else ((span + 31) // 32, 32, 1)
        nth = Cp * Tp  # threads of the strip, in order
        cap = nth * kcp
        nstrips = max(1, -(-span // cap)) if cap else 1

        def bval(j):
            return int(b[p, j - 1]) if 1 <= j <= LB else -2

        def row0(j):
            return 0 if (j >= bm and j - bm < W and j <= blen) else NEG

        acc = (NEG, 0, 0)
        ve = [0] * (LA + 1)
        ca = [NEG] * (LA + 1)
        for sp in range(nstrips):
            cs = cw0 + sp * cap
            ce = min(cw1, cs + cap - 1)
            first, last = sp == 0, sp == nstrips - 1
            mine = [[row0(cs + g * kcp + k) if cs + g * kcp + k <= ce else NEG
                     for k in range(kcp)] for g in range(nth)]
            vlast = [m[-1] if m else NEG for m in mine]
            pk = [[0] * kcp for _ in range(nth)]
            stage = {}
            vin = NEG if first else row0(cs - 1)
            pend = -1

            def gather(g):
                jb = 16 * g + 1 + bm
                nr = min(16, rows - 16 * g)
                for d in range(W):
                    j1 = jb + d
                    rmw = not first and cs - nr + 1 <= j1 < cs
                    own = (first or j1 >= cs) and (last or j1 < cs + cap)
                    if not own and not rmw:
                        continue
                    w = int(dirs[p, g, d]) if rmw else 0
                    if not (j1 + nr > 0 and j1 <= blen + 1):
                        w = sum(dead << (2 * r) for r in range(nr))
                    else:
                        for r in range(nr):
                            j = j1 + r
                            if j < 0 or j > blen + 1:
                                w |= dead << (2 * r)
                            elif cs <= j <= ce:
                                w |= stage[j] & (3 << (2 * r))
                    dirs[p, g, d] = w

            for i in range(1, rows + 1):
                av = int(a[p, i - 1])
                r0 = i + bm
                lo = max(0, r0, cs)
                hi = min(blen + 1, r0 + W - 1, ce)
                nwarps = nth // 32
                x = [NEG] * nth
                cin = [NEG] * nth
                part = [[0] * kcp for _ in range(nth)]
                tot, edg, wact = [NEG] * nwarps, [NEG] * nwarps, [False] * nwarps
                for gw in range(nwarps):  # pass 1
                    wcol0 = cs + gw * 32 * kcp
                    wcol1 = wcol0 + 32 * kcp - 1
                    wact[gw] = wcol0 <= hi and wcol1 >= lo
                    run = NEG
                    for lane in range(32):
                        g = gw * 32 + lane
                        dprev = vlast[g - 1] if lane > 0 else NEG
                        if lane == 0 and gw == 0 and not first:
                            dprev, vin, cin[g] = vin, ve[i], ca[i]
                        lmax = cin[g]
                        if wact[gw]:
                            for k in range(kcp):
                                j = cs + g * kcp + k
                                vold = mine[g][k]
                                m = bval(j) == av
                                diag = dprev + (match if m else mismatch)
                                bs = max(vold + gap, diag)
                                if j == 0:
                                    bs = max(bs, 0)
                                part[g][k] = (0 if m else 1) if bs == diag else 2
                                if lo <= j <= hi:
                                    mine[g][k] = bs
                                    lmax = max(lmax, bs - (j - r0) * gap)
                                dprev = vold
                        run = max(run, lmax)
                        x[g] = run
                    jn = wcol1 + 1
                    tn = NEG
                    if lo <= jn <= hi:
                        m = bval(jn) == av
                        tn = vlast[gw * 32 + 31] + (match if m else mismatch) - (jn - r0) * gap
                    tot[gw] = max(x[gw * 32 + 31], tn)
                    edg[gw] = vlast[gw * 32 + 31]
                sh = 2 * ((i - 1) % 16)
                for gw in range(nwarps):  # pass 2, after the barrier
                    carry = max(tot[:gw], default=NEG)
                    for lane in range(32):
                        g = gw * 32 + lane
                        excl = max(x[g - 1] if lane > 0 else NEG, carry)
                        if wact[gw]:
                            fix = lane == 0 and gw > 0
                            run = max(excl, cin[g])
                            for k in range(kcp):
                                j = cs + g * kcp + k
                                if not lo <= j <= hi:
                                    continue
                                bs, pt = mine[g][k], part[g][k]
                                if k == 0 and fix:
                                    m = bval(j) == av
                                    diag = edg[gw - 1] + (match if m else mismatch)
                                    bs = max(bs, diag)
                                    pt = (0 if m else 1) if bs == diag else 2
                                d = j - r0
                                run = max(run, bs - d * gap)
                                Vn = run + d * gap if j <= blen else NEG
                                pk[g][k] |= (3 if Vn > bs else pt) << sh
                                mine[g][k] = Vn
                                col = j <= blen and j == blen
                                key = 2 * i if col else 2 * i + 1
                                if (col or (j <= blen and i == alen)) and better(Vn, key, d, *acc):
                                    acc = (Vn, key, d)
                        vlast[g] = mine[g][-1] if kcp else NEG
                    if not last and gw == nwarps - 1:
                        ve[i] = vlast[nth - 1]
                        ca[i] = max(carry, x[nth - 1])
                if pend >= 0:
                    gather(pend)
                    pend = -1
                if i % 16 == 0 or i == rows:
                    for g in range(nth):
                        for k in range(kcp):
                            stage[cs + g * kcp + k] = pk[g][k]
                            pk[g][k] = 0
                    pend = (i - 1) // 16
            if pend >= 0:
                gather(pend)
        best[p], bi[p], bd[p] = acc[0], acc[1] >> 1, acc[2]
    dirs = np.where(dirs >= 2**31, dirs - 2**32, dirs).astype(np.int32)
    return dirs, best.astype(np.int32), bi.astype(np.int32), bd.astype(np.int32)


# (C, T, kc): the warp tier (kc None), one block of 2 warps, a cluster of
# 3 blocks, and strips of 64 and 96 columns (2 blocks of one warp).
ORDERS = {
    "warp": (1, 32, None),
    "block-2warps": (1, 64, 2),
    "cluster-3": (3, 64, 1),
    "strips-64": (2, 32, 1),
    "strips-96": (1, 96, 1),
}


def check_model(host, LA, W, order, kw):
    a, a_len, b, b_len, bm = prepared(host, LA, W)
    LB = b.shape[1]
    C, T, kc = ORDERS[order]
    got = model_rows(*(x.numpy() for x in (a, a_len, b, b_len, bm)),
                     LA=LA, LB=LB, W=W, C=C, T=T, kc=kc, **kw)
    ref = K.banded_fwd_plain(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W, **kw)
    words = (np.arange(K.n_words(LA))[None, :] * 16) < a_len.numpy()[:, None]
    assert np.array_equal(got[0][words], ref[0].numpy()[words])
    for x, y in zip(got[1:], ref[1:]):
        assert np.array_equal(x, y.numpy())


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("batch", ["full-32x128", "full-40x200-lb100", "edge", "mixed", "LA17"])
def test_model_matches_plain(batch, order):
    """The row-scan body's order of work equals the plain version on the
    full-matrix, edge-case, mixed-length and LA 17 batches, at each
    tier's order (warp, block, cluster, strips)."""
    host, LA, W = BATCHES[batch]()
    if batch == "edge":  # the edge-case batch, cut to keep the model quick
        host = edge_batch(64, 160)
        LA, W = 64, 160
    check_model(host, LA, W, order, SCORES["6/-1/-1"])


@pytest.mark.parametrize("scores", ["6/0/-1", "6/-1/-2"])
@pytest.mark.parametrize("order", ["warp", "cluster-3", "strips-64"])
def test_model_matches_plain_other_scores(order, scores):
    """The same at mismatch 0 and gap -2, whose dead-lane codes are 1 and
    2."""
    host, LA, W = BATCHES["full-40x200-lb100"]()
    check_model(host, LA, W, order, SCORES[scores])


@pytest.mark.parametrize("order", ["warp", "block-2warps", "strips-64"])
def test_model_matches_plain_sliding_band(order):
    """A band narrower than b (the window slides one column a row, and
    warps go idle as it passes them): the long-gap batch at W 48."""
    check_model(gap_batch(96, 48), 96, 48, order, SCORES["6/-1/-1"])


@pytest.mark.parametrize(
    "LA,LB,W,tier,cols,threads,blocks,strips",
    [
        (128, 128, 512, "warp", 5, 128, 1, 1),
        (128, 158, 512, "warp", 5, 128, 1, 1),
        (128, 159, 512, "warp", 9, 128, 1, 1),
        (512, 286, 2048, "warp", 9, 128, 1, 1),
        (512, 287, 2048, "block", 4, 96, 1, 1),
        (512, 512, 2048, "block", 4, 160, 1, 1),
        (512, 2046, 4096, "block", 4, 512, 1, 1),
        (512, 2047, 4096, "cluster", 4, 288, 2, 1),
        (16, 4096, 2048, "cluster", 4, 288, 2, 1),
        (4096, 4096, 2049, "cluster", 8, 288, 2, 1),
        (512, 8190, 16384, "cluster", 8, 512, 2, 1),
        (512, 8191, 16384, "cluster", 8, 352, 3, 1),
        (24576, 24576, 20480, "cluster", 8, 448, 7, 1),
        (512, 32766, 65536, "cluster", 8, 512, 8, 1),
        (512, 32767, 65536, "cluster", 8, 512, 8, 2),
        (256, 40256, 40000, "cluster", 8, 512, 8, 2),
        (16, 98302, 131072, "cluster", 8, 512, 8, 3),
        (16, 98303, 131072, "cluster", 8, 512, 8, 4),
    ],
)
def test_rows_plan_switch_points(LA, LB, W, tier, cols, threads, blocks, strips):
    """rows_plan sizes the launch by min(LB + 2, LA + W) columns: the warp
    tier's K steps at 160 and its edge at 288, the block tier up to 2048,
    then a cluster of one block per 4096 columns, 2 to 8, with 4 or 8
    columns a thread, strips of 32768 columns past 32768. A launch's
    threads hold the window in one strip, or in the strips."""
    plan = K.rows_plan(LA, LB, W)
    assert (plan["tier"], plan["cols_per_thread"], plan["threads"], plan["blocks"],
            plan["strips"]) == (tier, cols, threads, blocks, strips)
    if tier != "warp":
        cap = plan["threads"] * plan["cols_per_thread"] * plan["blocks"]
        assert cap * (plan["strips"] - 1) < plan["window"] <= cap * plan["strips"]
