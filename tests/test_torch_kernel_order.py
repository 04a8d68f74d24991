"""The CUDA kernels' orders of work, modelled in numpy, against the
plain version and the JAX package's kernel.

``banded_fwd``'s anti-diagonal body (csrc/banded_fwd_diag.cu) computes
the forward DP in another order than the row loop of
``banded_fwd_plain``: step s = 2i + d, K lanes per thread, the row's
prefix max as the recurrence U[d] = max(base[d], U[d-1] + gap) with the
scan's floor, the unmasked U carried to the right, and the inputs slid
between threads by shuffles. ``banded_tb`` (csrc/banded_tb.cu) walks the
path one warp per pair: a 32-lane chunk of dirs words per 16-row group,
ballots of its codes, the greatest qualifying lane. The models below
follow the kernels step by step (shuffles as shifts along the thread
axis, ballots as bit masks), so they check the reformulation without a
card. Every comparison is exact integer equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shasta_tpu_torch.ops import align_kernel as K
from tests.test_torch_align_kernel import KW, interpret_mode, jax_kernel  # noqa: F401
from tests.torch_common import (  # noqa: F401
    edge_batch, gap_batch, make_batch, mixed_batch, one_torch_thread,
)

NEG = K.NEG_INF


def lanes_per_thread(W):
    """The kernel's K: 2 lanes per thread up to W 64 (one warp), else 4."""
    return 2 if W <= 64 else 4


def warp_shfl_up(x):
    """Each thread takes the value of the thread before it in its warp;
    thread 0 of a warp keeps its own (__shfl_up_sync by 1)."""
    w = x.reshape(x.shape[0], -1, 32)
    return np.concatenate([w[:, :, :1], w[:, :, :-1]], axis=2).reshape(x.shape)


def warp_shfl_down(x):
    """Each thread takes the value of the thread after it in its warp;
    thread 31 keeps its own (__shfl_down_sync by 1)."""
    w = x.reshape(x.shape[0], -1, 32)
    return np.concatenate([w[:, :, 1:], w[:, :, -1:]], axis=2).reshape(x.shape)


def model_fwd(a, a_len, b, b_len, bm, *, LA, LB, W, match, mismatch, gap, P=1):
    """banded_fwd_diag_kernel<K, MULTI, P>: blocks of P pair slots (pairs
    blockIdx * P + s; the last block's slots past B read the block's
    first pair and own no row), ceil(W / 32K) warps, vectorized over the
    blocks and the block's threads. Each phase of a pair step runs over
    the slots in turn, as the kernel emits it (at P > 1 the 16-row stores
    of every slot follow the input slides); each block runs to the
    largest qend of its slots and skips a warp's cells where no lane of
    any slot is on a row. Across warps the edge values go through [P] x
    warps arrays (xu, xv) written and read around the two barriers.
    Returns (dirs with -1 in the words no lane stored, best, bi, bd) of
    the B pairs, and checks that no padding slot stored a word."""
    Bn = a.shape[0]
    NB = -(-Bn // P)  # blocks
    Kl = lanes_per_thread(W)
    H = Kl // 2
    nw = -(-W // (32 * Kl))
    T = 32 * nw
    t = np.arange(T)[None, :]
    xl, wp = t % 32, t // 32
    d0 = t * Kl
    slot = np.arange(NB * P).reshape(NB, P)
    real = slot < Bn
    pc = np.where(real, slot, slot[:, :1])  # the pair each slot reads
    a64, b64 = a.astype(np.int64), b.astype(np.int64)

    def col(x):
        return x[:, None].astype(np.int64)

    rows, alen, blen, bmc, ap, bp = [], [], [], [], [], []
    for s in range(P):
        alen.append(col(np.where(real[:, s], a_len[pc[:, s]], 0)))
        rows.append(np.minimum(alen[s], LA))
        blen.append(col(b_len[pc[:, s]]))
        bmc.append(col(bm[pc[:, s]]))
        ap.append(a64[pc[:, s]])
        bp.append(b64[pc[:, s]])
    rmax = np.max(np.stack(rows), axis=0)
    qend = np.where(rmax > 0, rmax + (W - 1) // 2, 0)  # (NB, 1)

    def load(src, idx, n, fill):
        idx = np.broadcast_to(idx, (NB, T))
        ok = (idx >= 0) & (idx < n)
        got = np.take_along_axis(src, np.clip(idx, 0, n - 1), axis=1)
        return np.where(ok, got, fill)

    def load_a(s, idx):
        return load(ap[s], idx, LA, -1)

    def load_b(s, idx):
        return load(bp[s], idx, LB, -2)

    nreal = np.clip(W - d0, 0, Kl)  # each thread's lanes < W
    V = [[None] * Kl for _ in range(P)]
    U = [[np.full((NB, T), NEG, np.int64) for _ in range(Kl)] for _ in range(P)]
    colv = [[np.full((NB, T), NEG, np.int64) for _ in range(Kl)] for _ in range(P)]
    pk = [[np.zeros((NB, T), np.int64) for _ in range(Kl)] for _ in range(P)]
    for s in range(P):
        for k in range(Kl):
            j = bmc[s] + d0 + k
            V[s][k] = np.where((k < nreal) & (j >= 0) & (j <= blen[s]), 0, NEG) + 0 * j
    dirs = np.full((NB * P, K.n_words(LA), W), -1, np.int64)
    xu = np.zeros((P, NB, nw), np.int64)  # shared memory, by pair and warp
    xv = np.zeros((P, NB, nw), np.int64)

    def cell(s, k, act, sh, j, lsrc, up, av, bval):
        """The kernel's cell(): commits V, U and the column end; returns
        the packed word with this row's code."""
        m = bval == av
        diag = V[s][k] + np.where(m, match, mismatch)
        base = np.maximum(up + gap, diag)
        base = np.where(j == 0, np.maximum(base, 0), base)
        u = np.maximum(lsrc + gap, base)
        v = np.where((j >= 0) & (j <= blen[s]), u, NEG)
        code = np.where(v > base, 3, np.where(base == diag, np.where(m, 0, 1), 2))
        colv[s][k] = np.where(act & (j == blen[s]), v, colv[s][k])
        V[s][k] = np.where(act, v, V[s][k])
        U[s][k] = np.where(act, u, U[s][k])
        return pk[s][k] | (code << sh)

    def store(s, k, flush, i):
        """wq[...] = pk[k] where the lane pair flushes and lane k < W."""
        ok = flush & (k < nreal)
        nb_, pt = np.nonzero(ok)
        ii = np.broadcast_to(i, (NB, T))[nb_, pt]
        dirs[slot[nb_, s], (ii - 1) >> 4, (d0 + k)[0, pt]] = pk[s][k][nb_, pt]

    def flush_pair(s, h, on, i):
        """Lane pair h of slot s stores its two words where its row ends a
        16-row group or is the slot's last row, and clears them."""
        flush = on & (i >= 1) & (i <= rows[s]) & (((i & 15) == 0) | (i == rows[s]))
        store(s, 2 * h, flush, i)
        store(s, 2 * h + 1, flush, i)
        pk[s][2 * h] = np.where(flush, 0, pk[s][2 * h])
        pk[s][2 * h + 1] = np.where(flush, 0, pk[s][2 * h + 1])

    def from_warp(x, src_wp, fill):
        """Thread t reads x[:, src_wp[t]] (a warp's shared slot), or fill
        where src_wp is outside the block."""
        ok = (src_wp >= 0) & (src_wp < nw)
        got = x[:, np.clip(src_wp, 0, nw - 1)[0]]
        return np.where(ok, got, fill)

    av = [[load_a(s, -t * H - h) for h in range(H)] for s in range(P)]
    bw = [[load_b(s, bmc[s] + t * H + h) for h in range(H + 1)] for s in range(P)]

    def chunk(s, q0):
        return np.where(
            xl < 16, load_a(s, q0 + xl - 16 * Kl * wp),
            load_b(s, bmc[s] + 16 * Kl * (wp + 1) + q0 + xl - 16),
        )

    cur = [chunk(s, 1) for s in range(P)]
    nx1 = [chunk(s, 17) for s in range(P)]
    nx2 = [chunk(s, 33) for s in range(P)]
    for q0 in range(1, int(qend.max()) + 1, 16):
        for r in range(min(16, int(qend.max()) - q0 + 1)):
            i0 = q0 + r - t * H
            q = q0 + r
            # A block stops at its own qend; a warp skips its cells at
            # steps where none of its lanes is on a row of any slot.
            on = (q <= qend) & (
                (nw == 1)
                | ((q >= 16 * Kl * wp + 1) & (q <= rmax + 16 * Kl * (wp + 1) - 1))
            )
            for s in range(P):  # even step, slot by slot
                j0 = bmc[s] + i0 + d0
                uin = warp_shfl_up(U[s][Kl - 1])
                lsrc0 = np.where(
                    xl != 0, uin,
                    np.where(wp == 0, NEG - gap, from_warp(xu[s], wp - 1, 0)),
                )
                for h in range(H):
                    i = i0 - h
                    act = on & (i >= 1) & (i <= rows[s]) & (2 * h < nreal)
                    w = cell(s, 2 * h, act, 2 * ((i - 1) & 15), j0 + h,
                             lsrc0 if h == 0 else U[s][2 * h - 1], V[s][2 * h + 1],
                             av[s][h], bw[s][h])
                    pk[s][2 * h] = np.where(act, w, pk[s][2 * h])
            for s in range(P):  # xl == 0 publishes V[0]; barrier
                xv[s] = V[s][0][:, ::32]
            for s in range(P):  # odd step (and at P = 1 the stores), slot by slot
                j0 = bmc[s] + i0 + d0
                vin = warp_shfl_down(V[s][0])
                up_last = np.where(xl != 31, vin, from_warp(xv[s], wp + 1, NEG))
                for h in range(H):
                    i = i0 - h
                    row_on = on & (i >= 1) & (i <= rows[s])
                    act = row_on & (2 * h + 1 < nreal)
                    w = cell(s, 2 * h + 1, act, 2 * ((i - 1) & 15), j0 + h + 1,
                             U[s][2 * h], up_last if h == H - 1 else V[s][2 * h + 2],
                             av[s][h], bw[s][h + 1])
                    pk[s][2 * h + 1] = np.where(act, w, pk[s][2 * h + 1])
                    if P == 1:
                        flush_pair(s, h, on, i)
            for s in range(P):  # xl == 31 publishes U[K - 1]; barrier
                xu[s] = U[s][Kl - 1][:, 31::32]
            for s in range(P):  # slides, slot by slot
                src = 32 * wp + np.where(xl == 0, r, 16 + r)
                sv = np.take_along_axis(cur[s], np.broadcast_to(src, (NB, T)), axis=1)
                na, nb = warp_shfl_up(av[s][H - 1]), warp_shfl_down(bw[s][1])
                av[s] = [np.where(xl == 0, sv, na)] + av[s][:-1]
                bw[s] = bw[s][1:] + [np.where(xl == 31, sv, nb)]
            if P > 1:  # every slot's stores follow the slides
                for s in range(P):
                    for h in range(H):
                        flush_pair(s, h, on, i0 - h)
        for s in range(P):
            cur[s], nx1[s], nx2[s] = nx1[s], nx2[s], chunk(s, q0 + 48)

    # Each lane's end: its last-column cell, then (strictly better) its
    # last-row cell; then the fold (max V, min packed row, min lane).
    best, bi, bd = [], [], []
    for s in range(P):
        lane_v, lane_im = [], []
        for k in range(Kl):
            c = colv[s][k] > NEG
            cv = np.where(c, colv[s][k], NEG)
            cim = np.where(c, 2 * (blen[s] - bmc[s] - d0 - k), 0)
            row = (rows[s] >= 1) & (rows[s] == alen[s]) & (V[s][k] > cv)
            lane_v.append(np.where(row, V[s][k], cv))
            lane_im.append(np.where(row, 2 * rows[s] + 1, cim))
        lv = np.stack(lane_v, axis=2).reshape(NB, T * Kl)[:, :W]
        li = np.stack(lane_im, axis=2).reshape(NB, T * Kl)[:, :W]
        bs = lv.max(axis=1)
        im = np.where(lv == bs[:, None], li, 1 << 40).min(axis=1)
        best.append(bs)
        bi.append(im >> 1)
        bd.append(np.argmax((lv == bs[:, None]) & (li == im[:, None]), axis=1))
    # Slot-major back to pair order; the padding slots write nothing.
    best, bi, bd = (np.stack(x, axis=1).reshape(-1)[:Bn] for x in (best, bi, bd))
    assert (dirs[Bn:] == -1).all()
    dirs = dirs[:Bn]
    dirs = np.where(dirs >= 2**31, dirs - 2**32, dirs)
    return dirs, best, bi, bd


def ballot(pred):
    return sum(1 << x for x in range(32) if pred[x])


KDOWN = 0xFFFFFFFF


def row_exits(words, r, c0, jb, W):
    """banded_tb.cu:row_exits for the 32 threads: each lane packs the
    exit ((e + 1) << 1) | match it would give, one vote marks the lanes
    that qualify (the j == 0 terminal or not LEFT), and thread x takes
    the packed exit of the greatest qualifying lane <= c0 + x (KDOWN when
    there is none and lanes below c0 remain)."""
    selfs, q = [], []
    for x, wd in enumerate(words):
        code = (wd >> (2 * (r & 15))) & 3
        d = c0 + x
        term = jb + d == 0
        q.append(term or code != 3)
        e = -1 if term else (d if code <= 1 else d + 1)
        e = -1 if e >= W else e
        selfs.append(((e + 1) << 1) | int(not term and code == 0 and jb + d > 0))
    qm = ballot(q)
    out = []
    for x in range(32):
        hit = qm & (((2 << x) - 1) & 0xFFFFFFFF)
        out.append(selfs[hit.bit_length() - 1] if hit else (KDOWN if c0 > 0 else 0))
    return out


def model_tb(dirs, bi, bd, bm, *, LA, W):
    """banded_tb_kernel, one pair at a time: lanes as lists, ballots as
    32-bit masks, a shuffle as a list index. Rows no store reaches keep
    a sentinel."""
    Bn = dirs.shape[0]
    mj = np.full((Bn, LA), -7, np.int64)
    for p in range(Bn):
        dp = dirs[p].astype(np.int64) & 0xFFFFFFFF
        out = mj[p]
        bip, bmp, e = int(bi[p]), int(bm[p]), int(bd[p])
        top = (((bip - 1) >> 5) << 5) + 32 if bip > 0 else 0
        out[top:] = -1
        if bip == 0:
            continue

        def chunk(w, c):
            return [int(dp[w, c + x]) if c + x < W else 0 for x in range(32)]

        def group_exits(words, w, c0):
            return [row_exits(words, 16 * w + k, c0, bmp + 16 * w + k + 1, W)
                    for k in range(16)]

        w = (bip - 1) >> 4
        tc = e & ~31
        words = chunk(w, tc)
        ex = group_exits(words, w, tc)
        pc = tc
        pre = chunk(w - 1, pc) if w > 0 else [0] * 32
        my = [-1] * 32
        for w in range(w, -1, -1):
            nex, npc, npre = None, pc, [0] * 32
            if e >= 0:
                if (e & ~31) != tc:
                    tc = e & ~31
                    words = chunk(w, tc)
                    ex = group_exits(words, w, tc)
                if w > 0:
                    nex = group_exits(pre, w - 1, pc)
                npc = tc
                npre = chunk(w - 2, npc) if w > 1 else [0] * 32
                k = min(15, bip - 1 - 16 * w)
                fast = True
                for kk in range(15, -1, -1):
                    pe = ex[kk][(e - tc) & 31]
                    fast = fast and (kk > k or (e >= 0 and (e & ~31) == tc and pe != KDOWN))
                    if fast and kk <= k:
                        r = 16 * w + kk
                        e = (pe >> 1) - 1
                        my[r & 31] = bmp + r + e if pe & 1 else -1
                        k = kk - 1
                c0 = tc
                while k >= 0 and e >= 0:
                    r = 16 * w + k
                    jb = bmp + r + 1
                    if (e & ~31) != c0:
                        c0 = e & ~31
                        words = chunk(w, c0)
                    pe = row_exits(words, r, c0, jb, W)[e - c0]
                    while pe == KDOWN:
                        c0 -= 32
                        words = chunk(w, c0)
                        pe = row_exits(words, r, c0, jb, W)[31]
                    e = (pe >> 1) - 1
                    my[r & 31] = jb + e - 1 if pe & 1 else -1
                    k -= 1
            if w & 1 == 0:
                for x in range(32):
                    if 16 * w + x < LA:
                        out[16 * w + x] = my[x]
                my = [-1] * 32
            ex, tc, words, pc, pre = nex, pc, pre, npc, npre
    return mj


def prepared(a, a_len, b, b_len, bm, LA, LB, W):
    args = [torch.from_numpy(np.asarray(x)) for x in (a, a_len, b, b_len, bm)]
    return [x.numpy() for x in K.prepare_inputs(*args, LA=LA, LB=LB, W=W)]


def check_against_plain(a, a_len, b, b_len, bm, LA, W, P=1):
    """Both models (the forward one with P pairs per warp) against
    banded_fwd_plain and banded_tb_plain on the same prepared inputs;
    returns the models' fused output."""
    kw = dict(LA=LA, LB=LA, W=W, **KW)
    pa, pal, pb, pbl, pbm = prepared(a, a_len, b, b_len, bm, LA, LA, W)
    dirs, best, bi, bd = model_fwd(pa, pal, pb, pbl, pbm, P=P, **kw)
    tp = [torch.from_numpy(x) for x in (pa, pal, pb, pbl, pbm)]
    pdirs, pbest, pbi, pbd = (x.numpy() for x in K.banded_fwd_plain(*tp, **kw))
    # Every word that holds a processed row is stored, and equal.
    held = (np.arange(K.n_words(LA))[None, :] * 16 < pal[:, None])[:, :, None]
    held = np.broadcast_to(held, dirs.shape)
    assert np.array_equal(dirs[held], pdirs[held])
    for got, ref in ((best, pbest), (bi, pbi), (bd, pbd)):
        assert np.array_equal(got, ref)
    mj = model_tb(pdirs, pbi, pbd, pbm, LA=LA, W=W)
    pmj = K.banded_tb_plain(
        torch.from_numpy(pdirs), torch.from_numpy(pbi), torch.from_numpy(pbd),
        torch.from_numpy(pbm), LA=LA, W=W,
    ).numpy()
    assert np.array_equal(mj, pmj)
    met = K.metrics_from_mj(torch.from_numpy(mj.astype(np.int32)), torch.from_numpy(pbest))
    return np.concatenate([met.numpy(), mj.astype(np.int32)], axis=1)


@pytest.mark.parametrize("LA", [1, 16, 17, 128, 256])
@pytest.mark.parametrize("W", [1, 5, 32, 33, 128, 288, 512, 2048])
def test_models_match_plain(W, LA):
    """Forward model: every dirs word of a processed row, best, bi and bd
    equal banded_fwd_plain's; traceback model: mj equals
    banded_tb_plain's. W 1 to 2048 covers one warp of K = 2 and 4 lanes
    per thread, blocks of 3, 4 and 16 warps, odd widths and phantom lanes
    past W."""
    a, a_len, b, b_len, bm = make_batch(LA * 31 + W, B=8, LA=LA, LB=LA, W=W)
    fused = check_against_plain(a, a_len, b, b_len, bm, LA, W)
    if LA >= 16 and W >= 32:
        assert (fused[:, 0] > 0).any()  # the batch has real alignments


@pytest.mark.parametrize("W", [128, 512])
def test_models_match_plain_across_chunks(W):
    """Paths with 40- and 70-long gaps, which cross the traceback's
    32-lane chunks: up (the entry leaves the chunk) and down (every lane
    of the chunk up to the entry is LEFT)."""
    a, a_len, b, b_len, bm = gap_batch(256, W)
    fused = check_against_plain(a, a_len, b, b_len, bm, 256, W)
    assert (fused[:, 0] > 100).all()  # every pair aligned through its gap


@pytest.mark.parametrize(
    "batch,LA,W",
    [("edge", 128, 128), ("make_batch", 128, 128), ("make_batch", 128, 288)],
)
def test_models_match_pallas_interpret(interpret_mode, batch, LA, W):
    """The models' fused (B, 16 + LA) output equals the JAX kernel's in
    Pallas interpret mode, exactly (the JAX kernel takes W in multiples
    of 16 lanes; W 288 gives the model 16 lanes per thread with phantom
    lanes past W)."""
    if batch == "edge":
        inputs = edge_batch(LA, W)
    else:
        inputs = make_batch(LA + W, B=8, LA=LA, LB=LA, W=W)
    got = check_against_plain(*inputs, LA, W)
    ref = jax_kernel(*[jnp.asarray(x) for x in inputs], LA=LA, LB=LA, W=W)
    assert ref.dtype == np.int32 and np.array_equal(got, ref)
    assert (got[:, 0] > 0).sum() >= 1


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("W", [1, 33, 128, 288, 512, 2048])
def test_waves_model_matches_plain(W, P):
    """The forward model with P pairs per warp (banded_fwd_waves) against
    banded_fwd_plain, word for word, on 7 pairs: the last block is partly
    padding (7 is no multiple of 2 or 4). W 1 to 2048: one warp of K = 2
    and 4 lanes per thread, blocks of 3, 4 and 16 warps."""
    LA = 128
    a, a_len, b, b_len, bm = make_batch(LA * 13 + W + P, B=7, LA=LA, LB=LA, W=W)
    fused = check_against_plain(a, a_len, b, b_len, bm, LA, W, P=P)
    if W >= 32:
        assert (fused[:, 0] > 0).any()


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("W", [128, 288])
def test_waves_model_mixed_lengths(W, P):
    """Pairs of very different a_len in one warp (0, 1, 2, 17, LA / 2,
    LA and LA + 40 beside each other), so that most pairs of a block end
    long before its last step; 13 pairs leave padding slots."""
    LA = 128
    a, a_len, b, b_len, bm = mixed_batch(LA, W, B=13)
    fused = check_against_plain(a, a_len, b, b_len, bm, LA, W, P=P)
    assert (fused[:, 0] > 10).sum() >= 4


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("W", [128, 512])
def test_waves_model_gap_batch(W, P):
    """The long-gap batch (paths across the traceback's 32-lane chunks)
    through the forward model with P pairs per warp."""
    a, a_len, b, b_len, bm = gap_batch(256, W)
    fused = check_against_plain(a, a_len, b, b_len, bm, 256, W, P=P)
    assert (fused[:, 0] > 100).all()


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("W", [128, 288])
def test_waves_model_matches_pallas_waves_interpret(interpret_mode, monkeypatch, W, P):
    """The P-pairs model's fused output equals the JAX package's
    _kernel_waves with waves = P in Pallas interpret mode, exactly; a spy
    shows the JAX run took the waves kernel (SHASTA_TPU_BB=32 gives it
    pair blocks that split into P sub-slabs of at least 8)."""
    import shasta_tpu.ops.align_pallas as AP

    monkeypatch.setenv("SHASTA_TPU_BB", "32")
    taken = []
    real = AP._kernel_waves

    def spy(*args, **kw):
        taken.append(kw["waves"])
        return real(*args, **kw)

    monkeypatch.setattr(AP, "_kernel_waves", spy)
    LA = 128
    inputs = mixed_batch(LA, W, B=11)
    got = check_against_plain(*inputs, LA, W, P=P)
    ref = jax_kernel(*[jnp.asarray(x) for x in inputs], LA=LA, LB=LA, W=W, waves=P)
    assert taken and set(taken) == {P}
    assert ref.dtype == np.int32 and np.array_equal(got, ref)
    assert (got[:, 0] > 0).sum() >= 4
