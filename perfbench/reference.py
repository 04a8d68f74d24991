"""Plain reference of the DP layer's output: which candidate pairs of
reads align, and on which markers (Shasta's alignment method 3, as
``Nanopore-May2022`` and ``Nanopore-UL-May2022`` run it).

It works everything out again from the reads the benchmark generated and
the configuration's parameters; it imports nothing of the program. From
the program it takes only the candidate pairs (read ids and strands),
which are the question the DP layer answers.

1. Reads shorter than ``minReadLength`` are dropped; the rest keep their
   FASTA order (their index is the read id) and are run-length encoded.
2. Markers: the k-mers (2-bit codes packed first base highest) of the
   run-length sequence that the configuration's random k-mer set holds.
   A k-mer and its reverse complement are chosen together, when
   MurmurHash64A of the canonical (smaller) id, as one 8-byte key with
   ``Kmers.seed``, is at most ``probability`` x 2^64. Strand 1 holds the
   reverse complements of strand 0's markers in reverse order.
3. Phase 1: the markers whose MurmurHash2 (32 bits) of
   id + reverse-complement id, seed 13477, lies below
   ``downsamplingFactor`` x 2^32 are aligned over the whole matrix; a
   pair whose downsampled lengths add up past the widest band class
   (2048) is banded on the densest window of diagonals of its shared
   k-mers, and dropped when it shares none. The matched rows give the
   band: the least and greatest original-ordinal offset, widened by
   ``bandExtend``; a band wider than ``maxBand`` is dropped.
4. Phase 2: the full marker sequences inside that band. The
   configuration states the band and no more (``band="stated"``); the
   program widens it to its DP's width class (128, 512, 2048, then
   doubling) about its centre (``band="class"``), which can move an
   answer. Either is sound: ``judge`` takes a program's answer when it
   equals the class answer or the stated one.
5. The alignment's metrics and the acceptance filters (``maxSkip``,
   ``maxDrift``, ``maxTrim``, ``minAlignedMarkerCount``,
   ``minAlignedFraction``).

The DP (both phases): banded overlap alignment with linear gaps; row i
(1..la) holds columns j = band_min + i + d, d in [0, W); free start on
row 0 and at j = 0, free end on the last row or the last column. Ties:
a cell takes LEFT only when it scores more than its diagonal and up
moves, then DIAG, then UP; the best end is the highest score, then the
earliest row, then the last column before the last row, then the lowest
lane; the traceback leaves each row at the greatest non-LEFT lane at or
below the lane it entered by. It runs as plain torch operations, a row
at a time over a batch of pairs, on the card when there is one.

``band="control"`` narrows phase 2 to the stated band less its
``bandExtend`` (the offsets of the phase-1 matches alone): the step to
fewer DP cells that a faster program would be tempted by. It has to
come out as not correct against both sound answers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

NEG = -(2 ** 30)
MATCH, MISMATCH, UP, LEFT, TERMINAL = 0, 1, 2, 3, 4
W_CLASSES = (128, 512, 2048)
# The DP keeps each cell's move code (a byte) for the traceback: at most
# this many bytes of them at once (a chunk of pairs).
CODES_BUDGET = 24 << 30
# Rows whose inputs, masks and keys are worked out together.
ROW_BLOCK = 32
_M64 = np.uint64(0xC6A4A7935BD1E995)
_M32 = np.uint32(0x5BD1E995)


@dataclass
class Params:
    min_read_length: int
    k: int
    probability: float
    kmer_seed: int
    downsampling_factor: float
    match: int
    mismatch: int
    gap: int
    band_extend: int
    max_band: int
    min_aligned_marker_count: int
    min_aligned_fraction: float
    max_skip: int
    max_drift: int
    max_trim: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Params":
        r = cfg["reference"]
        return cls(**{f: r[f] for f in cls.__dataclass_fields__})


# ---------------------------------------------------------------------------
# Hashes and markers
# ---------------------------------------------------------------------------


def murmur64a_u64(keys: np.ndarray, seed: int) -> np.ndarray:
    """MurmurHash64A of each 8-byte little-endian key."""
    k = np.asarray(keys, np.uint64).copy()
    with np.errstate(over="ignore"):
        h = np.full(k.shape, np.uint64(seed) ^ (np.uint64(8) * _M64), np.uint64)
        k *= _M64
        k ^= k >> np.uint64(47)
        k *= _M64
        h ^= k
        h *= _M64
        h ^= h >> np.uint64(47)
        h *= _M64
        h ^= h >> np.uint64(47)
    return h


def murmur2_u64(keys: np.ndarray, seed: int) -> np.ndarray:
    """32-bit MurmurHash2 of each 8-byte little-endian key."""
    keys = np.asarray(keys, np.uint64)
    h = np.full(keys.shape, np.uint32(seed) ^ np.uint32(8), np.uint32)
    with np.errstate(over="ignore"):
        for word in ((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (keys >> np.uint64(32)).astype(np.uint32)):
            w = word * _M32
            w ^= w >> np.uint32(24)
            w *= _M32
            h *= _M32
            h ^= w
        h ^= h >> np.uint32(13)
        h *= _M32
        h ^= h >> np.uint32(15)
    return h


def rc_kmers(ids: np.ndarray, k: int) -> np.ndarray:
    """Reverse complements of packed k-mer ids, base by base."""
    x = np.asarray(ids, np.uint64)
    out = np.zeros_like(x)
    for _ in range(k):
        out = (out << np.uint64(2)) | (np.uint64(3) - (x & np.uint64(3)))
        x = x >> np.uint64(2)
    return out


def rle(codes: np.ndarray) -> np.ndarray:
    if codes.shape[0] == 0:
        return codes
    keep = np.ones(codes.shape[0], bool)
    keep[1:] = codes[1:] != codes[:-1]
    return codes[keep]


def kmer_ids(seq: np.ndarray, k: int) -> np.ndarray:
    n = seq.shape[0] - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    v = np.zeros(n, np.uint64)
    s = seq.astype(np.uint64)
    for j in range(k):
        v = (v << np.uint64(2)) | s[j: j + n]
    return v


class Markers:
    """Marker k-mers of oriented reads, computed on demand from the
    reads' run-length sequences."""

    def __init__(self, reads_rle: Dict[int, np.ndarray], p: Params):
        self.rle = reads_rle
        self.p = p
        self._cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._thr = np.uint64(min(int(p.probability * float(2 ** 64)), 2 ** 64 - 1))
        self._ds_thr = np.uint32(min(int(p.downsampling_factor * float(2 ** 32)), 2 ** 32 - 1))

    def is_marker(self, ids: np.ndarray) -> np.ndarray:
        canonical = np.minimum(ids, rc_kmers(ids, self.p.k))
        return murmur64a_u64(canonical, self.p.kmer_seed) <= self._thr

    def get(self, read: int, strand: int) -> np.ndarray:
        """The oriented read's marker k-mer ids (int64), in order."""
        key = (read, strand)
        if key not in self._cache:
            ids = kmer_ids(self.rle[read], self.p.k)
            m = ids[self.is_marker(ids)]
            if strand:
                m = rc_kmers(m, self.p.k)[::-1]
            self._cache[key] = m.astype(np.int64)
        return self._cache[key]

    def downsampled(self, m: np.ndarray) -> np.ndarray:
        """Ordinals of the markers that phase 1 keeps."""
        u = m.astype(np.uint64)
        h = murmur2_u64(u + rc_kmers(u, self.p.k), 13477)
        return np.flatnonzero(h < self._ds_thr)


def w_class(width: int) -> int:
    for c in W_CLASSES:
        if width <= c:
            return c
    c = W_CLASSES[-1]
    while c < width:
        c *= 2
    return c


def dot_band(a: np.ndarray, b: np.ndarray, max_width: int):
    """(dmin, dmax) of the diagonals j - i of the k-mers a and b share,
    narrowed to the densest window that fits ``max_width`` when wider;
    None when they share none."""
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    pos_a = np.arange(a.shape[0])
    pos_b = np.arange(b.shape[0])
    amin = np.full(ua.shape[0], np.iinfo(np.int64).max)
    amax = np.full(ua.shape[0], -1)
    np.minimum.at(amin, ia, pos_a)
    np.maximum.at(amax, ia, pos_a)
    bmin = np.full(ub.shape[0], np.iinfo(np.int64).max)
    bmax = np.full(ub.shape[0], -1)
    np.minimum.at(bmin, ib, pos_b)
    np.maximum.at(bmax, ib, pos_b)
    shared, xa, xb = np.intersect1d(ua, ub, return_indices=True)
    if shared.shape[0] == 0:
        return None
    lo = bmin[xb] - amax[xa]
    hi = bmax[xb] - amin[xa]
    dmin, dmax = int(lo.min()), int(hi.max())
    if dmax - dmin + 3 > max_width:
        maxw = max_width - 3
        mids = np.sort((lo + hi) >> 1)
        cnt = np.searchsorted(mids, mids + maxw, side="right") - np.arange(mids.shape[0])
        start = int(mids[int(np.argmax(cnt))])
        dmin, dmax = max(dmin, start), min(dmax, start + maxw)
    return dmin, dmax


# ---------------------------------------------------------------------------
# The banded DP, a row at a time over a batch of pairs
# ---------------------------------------------------------------------------


def banded_dp(pairs: Sequence[Tuple[np.ndarray, np.ndarray, int, int]], match: int,
              mismatch: int, gap: int, device) -> List[np.ndarray]:
    """Each (a, b, band_min, W): the matched column of b for every row of
    a, or -1. Pairs are run together, widest bands first, in chunks whose
    (rows, pairs, lanes) codes fit CODES_BUDGET bytes."""
    out: List[Optional[np.ndarray]] = [None] * len(pairs)
    order = sorted(range(len(pairs)), key=lambda q: (-pairs[q][3], -pairs[q][0].shape[0]))
    lo = 0
    while lo < len(order):
        W = pairs[order[lo]][3]
        LA = 1
        hi = lo
        while hi < len(order):
            la = max(LA, pairs[order[hi]][0].shape[0])
            if hi > lo and (hi - lo + 1) * la * W > CODES_BUDGET:
                break
            LA, hi = la, hi + 1
        chunk = order[lo:hi]
        for q, mj in zip(chunk, _dp_chunk([pairs[q] for q in chunk], W, match, mismatch,
                                          gap, device)):
            out[q] = mj
        lo = hi
    return out


def _dp_chunk(pairs, Wmax, match, mismatch, gap, device):
    P = len(pairs)
    la = torch.tensor([p[0].shape[0] for p in pairs], dtype=torch.int64, device=device)
    lb = torch.tensor([p[1].shape[0] for p in pairs], dtype=torch.int64, device=device)
    bm = torch.tensor([p[2] for p in pairs], dtype=torch.int64, device=device)
    wp = torch.tensor([p[3] for p in pairs], dtype=torch.int64, device=device)
    LA = int(la.max())
    LB = int(lb.max())
    a = torch.full((P, LA + 1), -1, dtype=torch.int64)
    b = torch.full((P, LB + 1), -2, dtype=torch.int64)
    for q, (pa, pb, _bm, _w) in enumerate(pairs):
        a[q, : pa.shape[0]] = torch.from_numpy(pa)
        b[q, : pb.shape[0]] = torch.from_numpy(pb)
    a, b = a.to(device), b.to(device)
    d = torch.arange(Wmax, dtype=torch.int64, device=device)[None, :]
    lane = d < wp[:, None]
    dgap = d * gap
    neg = torch.full((P, 1), NEG, dtype=torch.int64, device=device)
    j0 = bm[:, None] + d
    prev = torch.where(lane & (j0 >= 0) & (j0 <= lb[:, None]), 0, NEG)
    best = torch.full((P, Wmax), NEG, dtype=torch.int64, device=device)
    best_key = torch.zeros((P, Wmax), dtype=torch.int64, device=device)
    codes = torch.empty((LA + 1, P, Wmax), dtype=torch.uint8, device=device)
    for r0 in range(1, LA + 1, ROW_BLOCK):
        R = min(ROW_BLOCK, LA + 1 - r0)
        ii = torch.arange(r0, r0 + R, dtype=torch.int64, device=device)[None, :, None]
        j = bm[:, None, None] + ii + d[:, None, :]
        bj = torch.gather(b, 1, (j - 1).clamp(0, LB).reshape(P, -1)).reshape(P, R, Wmax)
        bj = torch.where((j >= 1) & (j <= lb[:, None, None]), bj, -2)
        m = bj == a[:, r0 - 1: r0 - 1 + R, None]
        sub = torch.where(m, match, mismatch)
        valid = lane[:, None, :] & (j >= 0) & (j <= lb[:, None, None]) & (ii <= la[:, None, None])
        at_j0 = j == 0
        col_end = valid & (j == lb[:, None, None])
        end = col_end | (valid & (ii == la[:, None, None]))
        end_key = torch.where(col_end, 2 * ii, 2 * ii + 1).expand(P, R, Wmax)
        for r in range(R):
            diag = prev + sub[:, r]
            up = torch.cat([prev[:, 1:], neg], dim=1) + gap
            base = torch.maximum(diag, up)
            base = torch.where(at_j0[:, r], base.clamp(min=0), base)
            V = torch.cummax(base - dgap, dim=1).values + dgap
            V = torch.where(valid[:, r], V, NEG)
            codes[r0 + r] = torch.where(
                V > base, LEFT, torch.where(base == diag, torch.where(m[:, r], MATCH, MISMATCH), UP)
            ).to(torch.uint8)
            mv = torch.where(end[:, r], V, NEG)
            better = mv > best
            best = torch.where(better, mv, best)
            best_key = torch.where(better, end_key[:, r], best_key)
            prev = V
    top = best.max(dim=1, keepdim=True).values
    cand = best == top
    kmin = torch.where(cand, best_key, 1 << 40).min(dim=1, keepdim=True).values
    bd = torch.where(cand & (best_key == kmin), d, Wmax).min(dim=1).values
    bi = torch.where(top[:, 0] > NEG, kmin[:, 0] >> 1, 0)
    # Traceback.
    entry = torch.full((P,), -1, dtype=torch.int64, device=device)
    exit_key = torch.full((LA + 1, P), -1, dtype=torch.int64, device=device)
    for i in range(LA, 0, -1):
        entry = torch.where(bi == i, bd, entry)
        jrow = bm[:, None] + i + d
        code = torch.where(jrow == 0, TERMINAL, codes[i].to(torch.int64))
        key = torch.where((code != LEFT) & (d <= entry[:, None]), d * 8 + code, -1)
        kmax = key.max(dim=1).values
        exit_key[i] = kmax
        ex, ac = kmax >> 3, kmax & 7
        entry = torch.where(ac <= MISMATCH, ex, torch.where(ac == UP, ex + 1, -1))
        entry = torch.where(entry >= wp, -1, entry)
    rows = torch.arange(1, LA + 1, dtype=torch.int64, device=device)[:, None]
    k = exit_key[1:]
    j_exit = bm[None, :] + rows + (k >> 3)
    mj = torch.where(((k & 7) == MATCH) & (k >= 0) & (j_exit > 0), j_exit - 1, -1)
    mj = mj.t().cpu().numpy()
    return [mj[q, : pairs[q][0].shape[0]] for q in range(P)]


# ---------------------------------------------------------------------------
# Method 3
# ---------------------------------------------------------------------------


def metrics(mj: np.ndarray) -> Dict[str, int]:
    rows = np.flatnonzero(mj >= 0)
    cols = mj[rows]
    out = dict(marker_count=int(rows.shape[0]), first0=0, last0=0, first1=0, last1=0,
               min_offset=0, max_offset=0, max_skip_v=0, max_drift_v=0)
    if rows.shape[0]:
        off = rows - cols
        out.update(first0=int(rows[0]), last0=int(rows[-1]), first1=int(cols.min()),
                   last1=int(cols.max()), min_offset=int(off.min()), max_offset=int(off.max()))
    if rows.shape[0] > 1:
        out["max_skip_v"] = int(np.maximum(np.diff(rows), np.abs(np.diff(cols))).max())
        out["max_drift_v"] = int(np.abs(np.diff(rows - cols)).max())
    return out


def kept(m: Dict[str, int], n0: int, n1: int, p: Params) -> bool:
    mc = m["marker_count"]
    r0 = max(m["last0"] + 1 - m["first0"], 1)
    r1 = max(m["last1"] + 1 - m["first1"], 1)
    return bool(
        mc >= p.min_aligned_marker_count
        and min(mc / r0, mc / r1) >= p.min_aligned_fraction
        and min(m["first0"], m["first1"]) <= p.max_trim
        and min(n0 - 1 - m["last0"], n1 - 1 - m["last1"]) <= p.max_trim
        and m["max_skip_v"] <= p.max_skip
        and m["max_drift_v"] <= p.max_drift
    )


BANDS = ("class", "stated", "control")


def align(markers: Markers, candidates: Sequence[Tuple[int, int, bool]], p: Params,
          device, band: str = "class") -> List[Optional[dict]]:
    """Each candidate (read0, read1, same_strand): None when it yields no
    alignment, else its metrics, marker counts and matched ordinals.
    ``band`` is phase 2's band: one of ``BANDS`` (the module's notes)."""
    assert band in BANDS, band
    seqs = [(markers.get(r0, 0), markers.get(r1, 0 if ss else 1)) for r0, r1, ss in candidates]
    ph1, who = [], []
    for q, (A, B) in enumerate(seqs):
        sa, sb = markers.downsampled(A), markers.downsampled(B)
        la, lb = sa.shape[0], sb.shape[0]
        if la == 0 or lb == 0:
            continue
        bmin, width = -la, la + lb + 1
        if width > W_CLASSES[-1]:
            diagonals = dot_band(A[sa], B[sb], W_CLASSES[-1])
            if diagonals is None:
                continue
            bmin, width = diagonals[0] - 1, diagonals[1] - diagonals[0] + 3
        W = w_class(width)
        ph1.append((A[sa], B[sb], bmin - (W - width) // 2, W))
        who.append((q, sa, sb))
    ph2, who2 = [], []
    for (q, sa, sb), mj in zip(who, banded_dp(ph1, p.match, p.mismatch, p.gap, device)):
        rows = np.flatnonzero(mj >= 0)
        if rows.shape[0] == 0:
            continue
        off = sa[rows] - sb[mj[rows]]
        lo, hi = int(off.min()) - p.band_extend, int(off.max()) + p.band_extend
        if hi - lo > p.max_band:
            continue
        if band == "control":
            lo, hi = lo + p.band_extend, hi - p.band_extend
        width = hi - lo + 1
        W = w_class(width) if band == "class" else width
        ph2.append((seqs[q][0], seqs[q][1], -hi - (W - width) // 2, W))
        who2.append(q)
    out: List[Optional[dict]] = [None] * len(candidates)
    for q, mj in zip(who2, banded_dp(ph2, p.match, p.mismatch, p.gap, device)):
        m = metrics(mj)
        n0, n1 = seqs[q][0].shape[0], seqs[q][1].shape[0]
        if kept(m, n0, n1, p):
            rows = np.flatnonzero(mj >= 0)
            out[q] = dict(m, n_markers0=n0, n_markers1=n1, ord0=rows, ord1=mj[rows])
    return out


def same(ref: Optional[dict], got: Optional[dict]) -> bool:
    """Whether the program's answer for one candidate equals the
    reference's: both absent, or equal in every metric and ordinal."""
    if ref is None or got is None:
        return ref is None and got is None
    return all(
        np.array_equal(np.asarray(ref[f], np.int64), np.asarray(got[f], np.int64)) for f in ref
    )


def mismatched(markers: Markers, candidates: Sequence[Tuple[int, int, bool]], p: Params,
               device, answers: Sequence[Sequence[Optional[dict]]]) -> Tuple[int, int]:
    """How many of ``answers`` (one list a unit of work, an answer a
    candidate) equal neither the class answer nor the stated one; and
    how many candidates the reference aligns. The stated answers are
    worked out only for the candidates whose class answer some unit
    missed."""
    ref = align(markers, candidates, p, device)
    off = sorted({q for got in answers for q, g in enumerate(got) if not same(ref[q], g)})
    stated = dict(zip(off, align(markers, [candidates[q] for q in off], p, device, "stated")))
    bad = sum(not sound(ref[q], stated.get(q, ref[q]), g)
              for got in answers for q, g in enumerate(got))
    return bad, sum(r is not None for r in ref)


def sound(classed: Optional[dict], stated: Optional[dict], got: Optional[dict]) -> bool:
    """Whether an answer equals the class answer or the stated one."""
    return same(classed, got) or same(stated, got)
