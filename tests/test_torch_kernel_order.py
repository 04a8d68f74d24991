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
from tests.torch_common import edge_batch, gap_batch, make_batch, one_torch_thread  # noqa: F401

NEG = K.NEG_INF


def lanes_per_thread(W):
    """The kernel's K: 2 lanes per thread up to W 64 (one warp), else 4."""
    return 2 if W <= 64 else 4


def shfl_up(x):
    """Each thread takes its left neighbour's value, across warps too
    (a shuffle inside a warp, shared memory between warps); thread 0
    keeps its own."""
    return np.concatenate([x[:, :1], x[:, :-1]], axis=1)


def shfl_down(x):
    """Each thread takes its right neighbour's value; the last keeps its own."""
    return np.concatenate([x[:, 1:], x[:, -1:]], axis=1)


def model_fwd(a, a_len, b, b_len, bm, *, LA, LB, W, match, mismatch, gap):
    """banded_fwd_diag_kernel, vectorized over pairs and the block's
    threads (ceil(W / 32K) warps). Returns (dirs with -1 in the words no
    lane stored, best, bi, bd)."""
    Bn = a.shape[0]
    Kl = lanes_per_thread(W)
    H = Kl // 2
    nw = -(-W // (32 * Kl))
    T = 32 * nw
    t = np.arange(T)[None, :]
    xl, wp = t % 32, t // 32
    rows = np.minimum(a_len, LA)[:, None].astype(np.int64)
    alen = a_len[:, None].astype(np.int64)
    blen = b_len[:, None].astype(np.int64)
    bmc = bm[:, None].astype(np.int64)
    a64, b64 = a.astype(np.int64), b.astype(np.int64)
    d0 = t * Kl

    def load(src, idx, n, fill):
        ok = (idx >= 0) & (idx < n)
        got = np.take_along_axis(src, np.clip(idx, 0, n - 1), axis=1)
        return np.where(ok, got, fill)

    def load_a(idx):
        return load(a64, np.broadcast_to(idx, (Bn, T)), LA, -1)

    def load_b(idx):
        return load(b64, np.broadcast_to(idx, (Bn, T)), LB, -2)

    nreal = np.clip(W - d0, 0, Kl)  # each thread's lanes < W
    V, U, colv, pk = [], [], [], []
    for k in range(Kl):
        j = bmc + d0 + k
        V.append(np.where((k < nreal) & (j >= 0) & (j <= blen), 0, NEG) + 0 * bmc)
        U.append(np.full((Bn, T), NEG, np.int64))
        colv.append(np.full((Bn, T), NEG, np.int64))
        pk.append(np.zeros((Bn, T), np.int64))
    dirs = np.full((Bn, K.n_words(LA), W), -1, np.int64)

    def cell(k, act, sh, j, lsrc, up, av, bval):
        """The kernel's cell(): commits V, U and the column end; returns
        the packed word with this row's code."""
        m = bval == av
        diag = V[k] + np.where(m, match, mismatch)
        base = np.maximum(up + gap, diag)
        base = np.where(j == 0, np.maximum(base, 0), base)
        u = np.maximum(lsrc + gap, base)
        v = np.where((j >= 0) & (j <= blen), u, NEG)
        code = np.where(v > base, 3, np.where(base == diag, np.where(m, 0, 1), 2))
        colv[k] = np.where(act & (j == blen), v, colv[k])
        V[k] = np.where(act, v, V[k])
        U[k] = np.where(act, u, U[k])
        return pk[k] | (code << sh)

    def store(k, flush, i):
        """wp[...] = pk[k] where the lane pair flushes and lane k < W."""
        ok = flush & (k < nreal)
        pb, pt = np.nonzero(ok)
        ii = np.broadcast_to(i, (Bn, T))[pb, pt]
        dirs[pb, (ii - 1) >> 4, (d0 + k)[0, pt]] = pk[k][pb, pt]

    av = [load_a(-t * H - h) for h in range(H)]
    bw = [load_b(bmc + t * H + h) for h in range(H + 1)]

    def chunk(q0):
        return np.where(
            xl < 16, load_a(q0 + xl - 16 * Kl * wp),
            load_b(bmc + 16 * Kl * (wp + 1) + q0 + xl - 16),
        )

    qend = int(np.where(rows > 0, rows + (W - 1) // 2, 0).max())
    cur, nx1, nx2 = chunk(1), chunk(17), chunk(33)
    for q0 in range(1, qend + 1, 16):
        for r in range(min(16, qend - q0 + 1)):
            i0 = q0 + r - t * H
            j0 = bmc + i0 + d0
            q = q0 + r
            # The kernel skips a warp's cells at steps where none of its
            # lanes is on a row 1..rows.
            on = (q >= 16 * Kl * wp + 1) & (q <= rows + 16 * Kl * (wp + 1) - 1)
            uin = shfl_up(U[Kl - 1])
            lsrc0 = np.where(t == 0, NEG - gap, uin)
            for h in range(H):
                i = i0 - h
                act = on & (i >= 1) & (i <= rows) & (2 * h < nreal)
                w = cell(2 * h, act, 2 * ((i - 1) & 15), j0 + h,
                         lsrc0 if h == 0 else U[2 * h - 1], V[2 * h + 1], av[h], bw[h])
                pk[2 * h] = np.where(act, w, pk[2 * h])
            vin = shfl_down(V[0])
            up_last = np.where(t == T - 1, NEG, vin)
            for h in range(H):
                i = i0 - h
                row_on = on & (i >= 1) & (i <= rows)
                act = row_on & (2 * h + 1 < nreal)
                w = cell(2 * h + 1, act, 2 * ((i - 1) & 15), j0 + h + 1, U[2 * h],
                         up_last if h == H - 1 else V[2 * h + 2], av[h], bw[h + 1])
                pk[2 * h + 1] = np.where(act, w, pk[2 * h + 1])
                flush = row_on & (((i & 15) == 0) | (i == rows))
                store(2 * h, flush, i)
                store(2 * h + 1, flush, i)
                pk[2 * h] = np.where(flush, 0, pk[2 * h])
                pk[2 * h + 1] = np.where(flush, 0, pk[2 * h + 1])
            src = 32 * wp + np.where(xl == 0, r, 16 + r)
            sv = np.take_along_axis(cur, np.broadcast_to(src, (Bn, T)), axis=1)
            na, nb = shfl_up(av[H - 1]), shfl_down(bw[1])
            av = [np.where(xl == 0, sv, na)] + av[:-1]
            bw = bw[1:] + [np.where(xl == 31, sv, nb)]
        cur, nx1, nx2 = nx1, nx2, chunk(q0 + 48)

    # Each lane's end: its last-column cell, then (strictly better) its
    # last-row cell; then the fold (max V, min packed row, min lane).
    lane_v, lane_im = [], []
    for k in range(Kl):
        col = colv[k] > NEG
        cv = np.where(col, colv[k], NEG)
        cim = np.where(col, 2 * (blen - bmc - d0 - k), 0)
        row = (rows >= 1) & (rows == alen) & (V[k] > cv)
        lane_v.append(np.where(row, V[k], cv))
        lane_im.append(np.where(row, 2 * rows + 1, cim))
    lane_bv = np.stack(lane_v, axis=2).reshape(Bn, T * Kl)[:, :W]
    lane_im = np.stack(lane_im, axis=2).reshape(Bn, T * Kl)[:, :W]
    best = lane_bv.max(axis=1)
    im = np.where(lane_bv == best[:, None], lane_im, 1 << 40).min(axis=1)
    bd = np.argmax((lane_bv == best[:, None]) & (lane_im == im[:, None]), axis=1)
    dirs = np.where(dirs >= 2**31, dirs - 2**32, dirs)
    return dirs, best, im >> 1, bd


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


def check_against_plain(a, a_len, b, b_len, bm, LA, W):
    """Both models against banded_fwd_plain and banded_tb_plain on the
    same prepared inputs; returns the models' fused output."""
    kw = dict(LA=LA, LB=LA, W=W, **KW)
    pa, pal, pb, pbl, pbm = prepared(a, a_len, b, b_len, bm, LA, LA, W)
    dirs, best, bi, bd = model_fwd(pa, pal, pb, pbl, pbm, **kw)
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
