"""Batched banded marker-sequence alignment (method 3 semantics).

Counterpart of ``shasta_tpu/ops/align.py`` for PyTorch and CUDA. Method 3
(reference: src/AssemblerAlign3.cpp) runs in two phases:

1. find a diagonal band from matches between *downsampled* markers
   (strand-symmetric k-mer hash below downsamplingFactor * 2^32); the
   phase-1 DP runs on the downsampled sequences and a device-side
   reduction turns its matches into original-ordinal offsets;
2. run the banded overlap alignment over the full marker sequences
   inside that band and keep the matched ordinal pairs of the pairs that
   pass the acceptance filters.

Both phases run the banded DP of :mod:`shasta_tpu_torch.ops.align_kernel`
(CUDA kernels on a card, their plain PyTorch version on the CPU). The
marker CSR and its per-length-class padded matrices live on the device
as torch tensors; batches are built there by gather. Only pair ids,
lengths, bands, per-pair metrics and the compacted matches of kept pairs
cross to the host.

The shape classes (``_LEN_BUCKETS``, ``_W_BUCKETS``) and the band
centring ``bm = bmins - (w_k - widths) // 2`` are kept exactly: the W
class decides which band is aligned, so it is semantics, not tuning.
Batch sizes are the port's own (results are per pair).

Under a mesh (``parallel.context.current_mesh()``, installed by the
pipeline around computeAlignments) every rank holds the whole CSR and
builds the same batches; each batch is sharded over the ranks (rank r
aligns a contiguous 1/D of its pairs, the batch padded to a multiple of
D with empty pairs) and gathered before it is compacted or collected, so
every rank sees the single-device output (``parallel/mesh.py``).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from shasta_tpu_torch.ops import align_kernel as AK
from shasta_tpu_torch.parallel.context import current_mesh
from shasta_tpu_torch.utils.perf import StageProf


@dataclass
class AlignParams:
    """Scoring and banding parameters; defaults follow the reference
    Align section defaults (reference: src/AssemblerOptions.cpp)."""

    match_score: int = 6
    mismatch_score: int = -1
    gap_score: int = -1
    downsampling_factor: float = 0.1
    band_extend: int = 10
    max_band: int = 1000
    # Filters (applied by the caller after alignment):
    min_aligned_marker_count: int = 100
    min_aligned_fraction: float = 0.0
    max_skip: int = 30
    max_drift: int = 30
    max_trim: int = 30
    # Drop containment alignments: one read entirely covered by the
    # other, up to max_trim on both of its ends (reference:
    # Align.suppressContainments, AlignmentInfo classification).
    suppress_containments: bool = False


@dataclass
class AlignmentStore:
    """Accepted alignments and their metrics.

    Mirrors the reference's alignmentData + compressedAlignments
    (reference: src/Assembler.hpp:942-976): per alignment the read pair
    (read_id0 < read_id1, strand convention: oriented read 0 is
    (read_id0, 0), oriented read 1 is (read_id1, 0 if same_strand
    else 1)), the AlignmentInfo-style metrics, and the matched marker
    ordinal pairs stored flat + CSR offsets.
    """

    read_id0: np.ndarray  # int32 [n]
    read_id1: np.ndarray  # int32 [n]
    same_strand: np.ndarray  # bool [n]
    marker_count: np.ndarray  # int32 [n]  (matched markers)
    n_markers0: np.ndarray  # int32 [n]  (total markers in oriented read 0)
    n_markers1: np.ndarray  # int32 [n]
    first0: np.ndarray  # int32 [n]
    last0: np.ndarray  # int32 [n]
    first1: np.ndarray  # int32 [n]
    last1: np.ndarray  # int32 [n]
    min_offset: np.ndarray  # int32 [n]
    max_offset: np.ndarray  # int32 [n]
    max_skip_v: np.ndarray  # int32 [n]
    max_drift_v: np.ndarray  # int32 [n]
    ord0: np.ndarray  # uint16 (uint32 for >64k-marker reads) flat
    ord1: np.ndarray  # uint16/uint32 flat
    offsets: np.ndarray  # int64 [n+1]

    @property
    def count(self) -> int:
        return self.read_id0.shape[0]

    def ordinals(self, i: int):
        lo, hi = self.offsets[i], self.offsets[i + 1]
        return self.ord0[lo:hi], self.ord1[lo:hi]

    def check_strictly_increasing(self) -> bool:
        """Audit: within every alignment, both ordinal sequences are
        strictly increasing (reference: Alignment::
        checkStrictlyIncreasing, src/Alignment.hpp:48). One vectorized
        pass — within-alignment adjacency = consecutive flat entries
        not crossing a CSR boundary."""
        if self.ord0.shape[0] < 2:
            return True
        inc = (self.ord0[1:] > self.ord0[:-1]) & (
            self.ord1[1:] > self.ord1[:-1]
        )
        starts = np.zeros(self.ord0.shape[0], bool)
        starts[self.offsets[1:-1]] = True
        return bool((inc | starts[1:]).all())

    def arrays(self) -> Dict[str, np.ndarray]:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}

    @classmethod
    def from_arrays(cls, a) -> "AlignmentStore":
        return cls(**{k: a[k] for k in cls.__dataclass_fields__})

    # Trim helpers (reference: Alignment.hpp:279-287)
    def left_trim(self) -> np.ndarray:
        return np.minimum(self.first0, self.first1)

    def right_trim(self) -> np.ndarray:
        return np.minimum(
            self.n_markers0 - 1 - self.last0, self.n_markers1 - 1 - self.last1
        )

    def aligned_fraction_min(self) -> np.ndarray:
        r0 = (self.last0 + 1 - self.first0).astype(np.float64)
        r1 = (self.last1 + 1 - self.first1).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            f0 = np.where(r0 > 0, self.marker_count / r0, 0.0)
            f1 = np.where(r1 > 0, self.marker_count / r1, 0.0)
        return np.minimum(f0, f1)


def _metrics_from_ordinals(ord0: np.ndarray, ord1: np.ndarray) -> Tuple[int, ...]:
    """(max_skip, max_drift, min_off, max_off) for one alignment
    (reference: src/Alignment.cpp:4-29)."""
    if ord0.shape[0] == 0:
        return 0, 0, 0, 0
    o0 = ord0.astype(np.int64)
    o1 = ord1.astype(np.int64)
    off = o0 - o1
    if o0.shape[0] == 1:
        return 0, 0, int(off[0]), int(off[0])
    d0 = np.abs(np.diff(o0))
    d1 = np.abs(np.diff(o1))
    max_skip = int(np.maximum(d0, d1).max())
    max_drift = int(np.abs(np.diff(off)).max())
    return max_skip, max_drift, int(off.min()), int(off.max())


# ---------------------------------------------------------------------------
# Shape classes
# ---------------------------------------------------------------------------

# Length classes (marker counts) and band-width classes. A pair's W
# class sets the width of the band that is aligned, centred on the
# pair's own band; the length classes only pad.
_LEN_BUCKETS = [128, 512, 1024, 2048, 4096, 8192, 32768]
_W_BUCKETS = [128, 512, 2048]


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    # Beyond the precomputed buckets (ultra-long reads / very wide
    # phase-1 bands) extend in power-of-2 steps instead of silently
    # clamping — clamping would crash _pad_rows (length) or clip the
    # band so discovery misses the true diagonal (width). The CUDA
    # kernels take any LA and W without a new build.
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


def _bucket_vec(n: np.ndarray, buckets) -> np.ndarray:
    """Vectorized _bucket: smallest bucket >= n, extending past the
    table in power-of-2 steps."""
    b = np.asarray(buckets, np.int64)
    n = np.asarray(n, np.int64)
    idx = np.searchsorted(b, n)
    out = b[np.minimum(idx, len(b) - 1)]
    over = n > b[-1]
    if over.any():
        steps = np.ceil(np.log2(n[over] / b[-1])).astype(np.int64)
        out = out.copy()
        out[over] = b[-1] * (1 << steps)
    return out


def _dot_diag_band(ids_a, ids_b, flat, off, lens, max_width=None):
    """Per-pair diagonal range of exact k-mer matches ("dots") between
    two CSR rows, vectorized across pairs.

    Any DP matched pair is an exact k-mer match, and between two dots
    an optimal linear-gap path has an equal-scoring reordering whose
    intermediate diagonals stay inside the dots' diagonal range, so a
    band covering [dmin-1, dmax+1] preserves the optimal score of the
    unbanded alignment. Returns (dmin, dmax, has_dots); diagonals are
    j - i (b ordinal minus a ordinal).

    ``max_width``: when set and a pair's full dot range needs a band
    wider than this, the range narrows to the DENSEST window of dot
    diagonals whose band still fits (dmax-dmin+3 <= max_width). For
    ultra-long pairs the full range is inflated by spurious shared
    markers scattered across the whole dot plane, while any alignment
    the downstream maxBand filter (reference default 1000 original
    ordinals ~= 50 downsampled at downsamplingFactor 0.05,
    conf/Nanopore-May2022.conf) could accept concentrates its dots in
    a window far narrower than the kernel's widest band — so banding
    the densest window preserves every acceptable alignment while
    keeping the pair within the widest W class."""
    n = ids_a.shape[0]
    la = lens[ids_a].astype(np.int64)
    lb = lens[ids_b].astype(np.int64)

    def _per_key(ids, counts):
        # (pair, kmer) -> (min_ordinal, max_ordinal), sorted by key.
        pair_of = np.repeat(np.arange(n, dtype=np.int64), counts)
        starts = off[ids].astype(np.int64)
        iota = np.arange(pair_of.shape[0], dtype=np.int64)
        cum = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=cum[1:])
        ordi = iota - cum[pair_of]
        pos = np.repeat(starts - cum[:-1], counts) + iota
        km = flat[pos].astype(np.int64)
        order = np.lexsort((km, pair_of))
        p_s, k_s, o_s = pair_of[order], km[order], ordi[order]
        new = np.empty(order.shape[0], bool)
        if order.shape[0]:
            new[0] = True
            new[1:] = (p_s[1:] != p_s[:-1]) | (k_s[1:] != k_s[:-1])
        grp = np.flatnonzero(new)
        gmin = np.minimum.reduceat(o_s, grp) if grp.shape[0] else o_s[:0]
        gmax = np.maximum.reduceat(o_s, grp) if grp.shape[0] else o_s[:0]
        return p_s[grp], k_s[grp], gmin, gmax

    pa, ka, amin, amax = _per_key(ids_a, la)
    pb, kb, bmin_o, bmax_o = _per_key(ids_b, lb)
    # Merge-join the two sorted (pair, kmer) streams.
    # Pack into a single sortable key (kmer < 4^16 fits; pair small).
    KM = max(int(ka.max(initial=0)), int(kb.max(initial=0))) + 1
    keya = pa * KM + ka
    keyb = pb * KM + kb
    ia = np.searchsorted(keyb, keya)
    ia = np.minimum(ia, keyb.shape[0] - 1) if keyb.shape[0] else ia
    shared = keyb.shape[0] > 0
    dmin = np.full(n, np.iinfo(np.int64).max, np.int64)
    dmax = np.full(n, np.iinfo(np.int64).min, np.int64)
    if shared and keya.shape[0]:
        hit = keyb[ia] == keya
        ha = np.flatnonzero(hit)
        hb = ia[ha]
        p = pa[ha]
        lo = bmin_o[hb] - amax[ha]  # min diagonal for this kmer
        hi = bmax_o[hb] - amin[ha]  # max diagonal
        np.minimum.at(dmin, p, lo)
        np.maximum.at(dmax, p, hi)
        if max_width is not None:
            over = (dmax - dmin + 3) > max_width
            if over.any():
                maxw = int(max_width) - 3
                mid = (lo + hi) >> 1
                sel = over[p]
                ps, ms = p[sel], mid[sel]
                order = np.lexsort((ms, ps))
                ps, ms = ps[order], ms[order]
                # Count dots in [m, m+maxw] per starting dot with one
                # global searchsorted (keys strictly separate pairs).
                base = ms - ms.min()
                span = int(base.max()) + maxw + 2
                key = ps * span + base
                upper = np.searchsorted(key, key + maxw, side="right")
                cnt = upper - np.arange(ps.shape[0])
                new_grp = np.empty(ps.shape[0], bool)
                new_grp[0] = True
                np.not_equal(ps[1:], ps[:-1], out=new_grp[1:])
                grp = np.flatnonzero(new_grp)
                gid = np.cumsum(new_grp) - 1
                gbest = np.maximum.reduceat(cnt, grp)
                at_best = cnt == gbest[gid]
                idx = np.where(
                    at_best,
                    np.arange(ps.shape[0], dtype=np.int64),
                    np.iinfo(np.int64).max,
                )
                gfirst = np.minimum.reduceat(idx, grp)
                pair_ids = ps[grp]
                start = ms[gfirst]
                dmin[pair_ids] = np.maximum(dmin[pair_ids], start)
                dmax[pair_ids] = np.minimum(dmax[pair_ids], start + maxw)
    has = dmax >= dmin
    return dmin, dmax, has



def _keep_mask_from_metrics(metrics, n0, n1, params: AlignParams):
    """The reference's alignment acceptance filters as one vectorized
    pass over the in-kernel metrics (reference:
    AssemblerAlign.cpp:437-470). metrics: (n, >=9) int rows
    [count, first0, last0, first1, last1, min_off, max_off, max_skip,
    max_drift, ...]; n0/n1 the total marker counts of each pair's
    oriented reads."""
    mc = metrics[:, 0]
    first0, last0 = metrics[:, 1], metrics[:, 2]
    first1, last1 = metrics[:, 3], metrics[:, 4]
    mskip, mdrift = metrics[:, 7], metrics[:, 8]
    with np.errstate(divide="ignore", invalid="ignore"):
        range0 = np.maximum(last0 + 1 - first0, 1)
        range1 = np.maximum(last1 + 1 - first1, 1)
        frac = np.minimum(mc / range0, mc / range1)
    keep = (
        (mc >= params.min_aligned_marker_count)
        & (frac >= params.min_aligned_fraction)
        & (np.minimum(first0, first1) <= params.max_trim)
        & (np.minimum(n0 - 1 - last0, n1 - 1 - last1) <= params.max_trim)
        & (mskip <= params.max_skip)
        & (mdrift <= params.max_drift)
    )
    if params.suppress_containments:
        contained0 = (first0 <= params.max_trim) & (
            n0 - 1 - last0 <= params.max_trim
        )
        contained1 = (first1 <= params.max_trim) & (
            n1 - 1 - last1 <= params.max_trim
        )
        keep &= ~(contained0 | contained1)
    return keep



# ---------------------------------------------------------------------------
# Device-side batch construction
# ---------------------------------------------------------------------------

# Pairs per key before the streaming runner dispatches it, and the cap
# on pairs per batch (the kernel wrapper splits a batch further by its
# dirs byte budget). Results are per pair, so these only shape launches.
_FLUSH_PAIRS = 4096
_MAX_BATCH = 16384

# Device-residency budgets (MiB), sized for an 80 GB H100: the LRU cache
# of class matrices, and the queued phase-2 outputs above which the
# runner compacts the oldest batches during dispatch. Ranks of a mesh
# that share one card split both (``_budget_mb``).
_MAT_MB_DEFAULT = 16384
_DEVQ_MB_DEFAULT = 8192


def _budget_mb(var: str, default: int) -> int:
    """A device budget in MiB from ``var`` (else ``default``), divided by
    the ranks of the current mesh that share this rank's device."""
    mesh = current_mesh()
    share = mesh.ranks_per_device if mesh is not None else 1
    return int(os.environ.get(var, default)) // share


def _batch_plan(n: int, LA: int, LB: int, W: int, mesh_d: int = 1):
    """(lo, hi) slices of n same-class pairs. Small shapes (phase-1
    band discovery) take larger batches, so that a launch carries
    comparable work to the full-alignment shapes. Under a mesh of
    ``mesh_d`` ranks a full batch is a multiple of ``mesh_d`` (the
    sharded call pads the last one)."""
    factor = max(1, (4 * 512 * 512 * 128) // max(1, LA * LB * W))
    max_b = min(_MAX_BATCH, 1024 * factor)
    max_b = max(mesh_d, max_b - max_b % mesh_d)
    for lo in range(0, n, max_b):
        yield lo, min(lo + max_b, n)


def _build_class_matrix(src, off, lens, L: int, fill: int):
    """(n, L) int32 rows of the flat CSR ``src`` starting at ``off``,
    filled with ``fill`` beyond each row's length (one device gather)."""
    nf = src.shape[0]
    t = torch.arange(L, dtype=torch.int64, device=src.device)[None, :]
    pos = (off[:, None] + t).clamp_(0, max(nf - 1, 0))
    x = src[pos] if nf else torch.full(pos.shape, fill, dtype=torch.int32, device=src.device)
    return torch.where(t < lens[:, None], x, fill).to(torch.int32)


def _take_rows(mat, rows, lens, fill: int):
    """Whole-row take from a class matrix, re-filled beyond each row's
    length."""
    t = torch.arange(mat.shape[1], dtype=torch.int32, device=mat.device)[None, :]
    x = mat.index_select(0, rows)
    return torch.where(t < lens[:, None], x, fill).to(torch.int32).contiguous()


class _DeviceCsr:
    """Device-resident per-length-class padded marker matrices.

    The flat CSR is uploaded once; a class matrix (every row whose
    length falls in one class, padded to the class length) is built by
    one gather the first time a batch of that class runs, and kept in
    an LRU cache under a byte budget (``SHASTA_TORCH_MAT_MB``; a quarter
    of it for the phase-1 CSR, whose matrices are ~10x smaller; split
    between the ranks of a mesh that share the card). Under a mesh each
    rank holds its own copy (the JAX package replicates the class
    matrices over its mesh). An
    evicted class is rebuilt on demand. PyTorch's allocator is
    stream-ordered, so dropping a cached matrix that queued work still
    reads is safe: its memory is reused only by later work."""

    def __init__(self, flat, off, lens, device, aux=None):
        self.device = torch.device(device)
        self.flat_dev = torch.from_numpy(
            np.ascontiguousarray(flat, dtype=np.int32)
        ).to(self.device)
        self.aux_dev = None
        if aux is not None:
            self.aux_dev = torch.from_numpy(
                np.ascontiguousarray(aux, dtype=np.int32)
            ).to(self.device)
        self.lens = np.asarray(lens, np.int64)
        self.off = np.asarray(off, np.int64)
        cls = _bucket_vec(np.maximum(self.lens, 1), _LEN_BUCKETS)
        order = np.argsort(cls, kind="stable")
        sorted_cls = cls[order]
        starts = np.searchsorted(sorted_cls, sorted_cls, side="left")
        self.local = np.empty(order.shape[0], np.int64)
        self.local[order] = np.arange(order.shape[0], dtype=np.int64) - starts
        self._members = {
            int(c): order[sorted_cls == c] for c in np.unique(sorted_cls)
        }
        budget_mb = _budget_mb("SHASTA_TORCH_MAT_MB", _MAT_MB_DEFAULT)
        if aux is not None:
            budget_mb //= 4
        self._mat_budget = budget_mb << 20
        self._cache: "OrderedDict[Tuple[str, int], Tuple[torch.Tensor, int]]" = (
            OrderedDict()
        )
        self.builds = 0

    def _class_matrix(self, kind: str, src, L: int):
        key = (kind, L)
        entry = self._cache.get(key)
        if entry is not None:
            self._cache.move_to_end(key)
            return entry[0]
        ids = self._members.get(L, np.zeros(0, np.int64))
        nbytes = ids.shape[0] * L * 4
        total = sum(b for _, b in self._cache.values()) + nbytes
        while total > self._mat_budget and self._cache:
            _k, (_m, b_old) = self._cache.popitem(last=False)
            total -= b_old
        off = torch.from_numpy(self.off[ids]).to(self.device)
        lens = torch.from_numpy(self.lens[ids]).to(self.device)
        m = _build_class_matrix(src, off, lens, L, fill=-1)
        self._cache[key] = (m, nbytes)
        self.builds += 1
        return m

    def matrix(self, L: int):
        return self._class_matrix("m", self.flat_dev, L)

    def aux_matrix(self, L: int):
        return self._class_matrix("aux", self.aux_dev, L)


def _dispatch_csr(
    dev_csr: _DeviceCsr,
    ids_a: np.ndarray,
    ids_b: np.ndarray,
    band_mins: np.ndarray,
    W: int,
    LA: int,
    LB: int,
    params: AlignParams,
    band_fused: bool = False,
):
    """Run every batch of one (LA, LB, W) class; rows are CSR row ids
    whose lengths all fall in the class. Returns pending entries
    (kind, device payload, n): ``("band", (n, 3) [count, min_offset,
    max_offset])`` with ``band_fused`` (the CSR carries each downsampled
    marker's original ordinal as ``aux``), else ``("p2", (n, 16 + LA)
    fused metrics + matches)``. Under a mesh each batch is sharded over
    its ranks and gathered (``sharded_band_take``, ``sharded_align_take``)."""
    dev = dev_csr.device
    mesh = current_mesh()
    kw = dict(
        LA=LA, LB=LB, W=W, match=params.match_score,
        mismatch=params.mismatch_score, gap=params.gap_score,
    )
    pending = []
    for lo, hi in _batch_plan(ids_a.shape[0], LA, LB, W, mesh.size if mesh else 1):
        ia = ids_a[lo:hi]
        ib = ids_b[lo:hi]

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        rowa = put(dev_csr.local[ia])
        rowb = put(dev_csr.local[ib])
        a_len = put(dev_csr.lens[ia].astype(np.int32))
        b_len = put(dev_csr.lens[ib].astype(np.int32))
        bm = put(np.asarray(band_mins[lo:hi], np.int32))
        if mesh is not None:
            from shasta_tpu_torch.parallel import mesh as M

            if band_fused:
                band = M.sharded_band_take(
                    mesh, dev_csr.matrix(LA), rowa, dev_csr.aux_matrix(LA),
                    dev_csr.matrix(LB), rowb, dev_csr.aux_matrix(LB),
                    a_len, b_len, bm, **kw,
                )
                pending.append(("band", band, hi - lo))
            else:
                fused = M.sharded_align_take(
                    mesh, dev_csr.matrix(LA), rowa, dev_csr.matrix(LB), rowb,
                    a_len, b_len, bm, **kw,
                )
                pending.append(("p2", fused, hi - lo))
            continue
        a = _take_rows(dev_csr.matrix(LA), rowa, a_len, -1)
        b = _take_rows(dev_csr.matrix(LB), rowb, b_len, -2)
        fused = AK.banded_align_pairs(a, a_len, b, b_len, bm, **kw)
        if band_fused:
            orda = _take_rows(dev_csr.aux_matrix(LA), rowa, a_len, 0)
            ordb = _take_rows(dev_csr.aux_matrix(LB), rowb, b_len, 0)
            pending.append(
                ("band", AK.band_reduce(fused[:, 16:], orda, ordb), hi - lo)
            )
        else:
            pending.append(("p2", fused, hi - lo))
    return pending


def _entry_dev_bytes(entry) -> int:
    kind, payload, _n = entry
    if kind in ("p2", "band"):
        return payload.numel() * payload.element_size()
    return 0


def _entry_to_flat(entry):
    """Metrics and flat matches of one unfiltered batch: (met (n, 10)
    int64, rows, cols, vals), rows batch-local ascending, cols/vals the
    matched (ordinal0, ordinal1) pairs in path order. The nonzero runs
    on the device; only the matches cross."""
    kind, fused, _n = entry
    if kind != "p2":
        raise ValueError(f"not an unfiltered phase-2 batch: {kind!r}")
    met = fused[:, :10].cpu().numpy().astype(np.int64)
    mj = fused[:, 16:]
    nz = (mj >= 0).nonzero()
    vals = mj[nz[:, 0], nz[:, 1]]
    rows = nz[:, 0].cpu().numpy()
    cols = nz[:, 1].cpu().numpy()
    return met, rows, cols, vals.cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# Grouped route: pairs given as host rows (method 4)
# ---------------------------------------------------------------------------


def _pad_rows(rows: List[np.ndarray], width: int, pad: int) -> np.ndarray:
    out = np.full((len(rows), width), pad, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : r.shape[0]] = r
    return out


def _dispatch_grouped(
    a_rows: List[np.ndarray],
    b_rows: List[np.ndarray],
    band_mins: np.ndarray,
    widths: np.ndarray,
    params: AlignParams,
    device,
):
    """Group pairs into (LA, LB, W) classes, taken in sorted order, and
    launch every batch of each class. Each band is centred inside its
    class width. Returns [(pair indices, pending "p2" entry)], one per
    batch. Under a mesh each batch is sharded over its ranks and
    gathered (``sharded_pallas_align``)."""
    order: Dict[Tuple[int, int, int], List[int]] = {}
    for i in range(len(a_rows)):
        key = (
            _bucket(a_rows[i].shape[0], _LEN_BUCKETS),
            _bucket(b_rows[i].shape[0], _LEN_BUCKETS),
            _bucket(int(widths[i]), _W_BUCKETS),
        )
        order.setdefault(key, []).append(i)

    mesh = current_mesh()

    def put(x):
        x = np.ascontiguousarray(x)
        # Under a mesh the sharded call uploads each rank's share.
        return x if mesh is not None else torch.from_numpy(x).to(device)

    dispatched = []
    for (LA, LB, W), idxs in sorted(order.items()):
        bm_all = np.asarray(
            [int(band_mins[i]) - (W - int(widths[i])) // 2 for i in idxs], np.int32
        )
        kw = dict(
            LA=LA, LB=LB, W=W, match=params.match_score,
            mismatch=params.mismatch_score, gap=params.gap_score,
        )
        for lo, hi in _batch_plan(len(idxs), LA, LB, W, mesh.size if mesh else 1):
            sel = idxs[lo:hi]
            args = (
                put(_pad_rows([a_rows[i] for i in sel], LA, -1)),
                put(np.asarray([a_rows[i].shape[0] for i in sel], np.int32)),
                put(_pad_rows([b_rows[i] for i in sel], LB, -2)),
                put(np.asarray([b_rows[i].shape[0] for i in sel], np.int32)),
                put(bm_all[lo:hi]),
            )
            if mesh is not None:
                from shasta_tpu_torch.parallel.mesh import sharded_pallas_align

                fused = sharded_pallas_align(mesh, *args, **kw)
            else:
                fused = AK.banded_align_pairs(*args, **kw)
            dispatched.append((sel, ("p2", fused, hi - lo)))
    return dispatched


def _grouped_run(
    a_rows: List[np.ndarray],
    b_rows: List[np.ndarray],
    band_mins: np.ndarray,
    widths: np.ndarray,
    params: AlignParams,
    device="cuda",
):
    """Align pairs of host rows in their (LA, LB, W) classes. Returns
    (results, metrics): results[i] the matched (ord0, ord1) uint32
    ordinals of pair i in path order, metrics (n, 10) int64 rows
    [count, first0, last0, first1, last1, min_off, max_off, max_skip,
    max_drift, score] from :func:`align_kernel.metrics_from_mj`.
    ``device``: "cuda" (the kernels) unless the caller asks for "cpu"."""
    device = AK.resolve_device(device)
    n = len(a_rows)
    results: List[Tuple[np.ndarray, np.ndarray]] = [None] * n  # type: ignore[list-item]
    metrics = np.zeros((n, 10), np.int64)
    for idxs, entry in _dispatch_grouped(
        a_rows, b_rows, band_mins, widths, params, device
    ):
        met, rows, cols, vals = _entry_to_flat(entry)
        starts = np.searchsorted(rows, np.arange(len(idxs) + 1))
        for t, i in enumerate(idxs):
            lo, hi = starts[t], starts[t + 1]
            results[i] = (cols[lo:hi].astype(np.uint32), vals[lo:hi].astype(np.uint32))
        metrics[np.asarray(idxs)] = met
    return results, metrics


class _CsrStreamingRunner:
    """Accumulates pair row ids (into a shared CSR of marker sequences)
    per (LA, LB, W) class and dispatches a class as soon as it holds
    ``_FLUSH_PAIRS`` pairs.

    With a ``keep_fn``, dispatched phase-2 batches whose device outputs
    exceed ``SHASTA_TORCH_DEVQ_MB`` are drained oldest first during
    dispatch (the budget split between the ranks of a mesh that share
    the card): their metrics come to the host, ``keep_fn(tags, met)``
    selects the pairs that pass the acceptance filters, and only those
    pairs' matches are compacted on the device and fetched. A drained
    batch has no unfiltered output left, so :meth:`collect_flat` raises
    on it, and :meth:`collect_filtered_metrics` refuses a different
    filter than the one it was drained with."""

    def __init__(self, flat, off, lens, params: AlignParams, device, keep_fn=None):
        self.lens = np.asarray(lens, np.int64)
        self.params = params
        self.dev_csr = _DeviceCsr(flat, off, lens, device)
        self.buffers: Dict[Tuple[int, int, int], List] = {}
        self.counts: Dict[Tuple[int, int, int], int] = {}
        # [tags, entry] per dispatched batch, in dispatch order.
        self.batches: List[List] = []
        self.keep_fn = keep_fn
        self._dev_bytes = 0
        self._drain_budget = _budget_mb("SHASTA_TORCH_DEVQ_MB", _DEVQ_MB_DEFAULT) << 20
        self._drain_ptr = 0
        self.drained = 0

    def add_many(self, ids_a, ids_b, band_mins, widths, tags):
        ids_a = np.asarray(ids_a, np.int64)
        ids_b = np.asarray(ids_b, np.int64)
        band_mins = np.asarray(band_mins, np.int64)
        widths = np.asarray(widths, np.int64)
        tags = np.asarray(tags, np.int64)
        key_mat = np.stack(
            [
                _bucket_vec(self.lens[ids_a], _LEN_BUCKETS),
                _bucket_vec(self.lens[ids_b], _LEN_BUCKETS),
                _bucket_vec(widths, _W_BUCKETS),
            ],
            axis=1,
        )
        uk, inv = np.unique(key_mat, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        for ki in range(uk.shape[0]):
            sel = np.flatnonzero(inv == ki)
            key = tuple(int(x) for x in uk[ki])
            self.buffers.setdefault(key, []).append(
                (ids_a[sel], ids_b[sel], band_mins[sel], widths[sel], tags[sel])
            )
            self.counts[key] = self.counts.get(key, 0) + sel.shape[0]
            if self.counts[key] >= _FLUSH_PAIRS:
                self._flush(key)

    def _flush(self, key):
        buf = self.buffers.pop(key, None)
        self.counts.pop(key, None)
        if not buf:
            return
        la_k, lb_k, w_k = key
        ids_a = np.concatenate([c[0] for c in buf])
        ids_b = np.concatenate([c[1] for c in buf])
        bmins = np.concatenate([c[2] for c in buf])
        widths = np.concatenate([c[3] for c in buf])
        tags = np.concatenate([c[4] for c in buf])
        # Centre each band inside the padded width.
        bm = (bmins - (w_k - widths) // 2).astype(np.int32)
        pending = _dispatch_csr(
            self.dev_csr, ids_a, ids_b, bm, w_k, la_k, lb_k, self.params
        )
        lo = 0
        for entry in pending:
            n_real = entry[2]
            self.batches.append([tags[lo : lo + n_real], entry])
            self._dev_bytes += _entry_dev_bytes(entry)
            lo += n_real
        if self.keep_fn is not None:
            self._maybe_drain()

    def flush_all(self):
        for key in list(self.buffers):
            self._flush(key)

    def _compact(self, i: int, keep_fn) -> None:
        """Replace batch i's device output by its host metrics and the
        matches of the pairs ``keep_fn`` keeps (compacted on device)."""
        tags, entry = self.batches[i]
        fused = entry[1]
        met = fused[:, :10].cpu().numpy().astype(np.int64)
        sel = np.flatnonzero(np.asarray(keep_fn(tags, met), bool))
        rows = cols = vals = np.zeros(0, np.int64)
        if sel.shape[0]:
            idx = torch.from_numpy(sel).to(fused.device)
            mjk = fused.index_select(0, idx)[:, 16:]
            nz = (mjk >= 0).nonzero()
            v = mjk[nz[:, 0], nz[:, 1]]
            rows = sel[nz[:, 0].cpu().numpy()]
            cols = nz[:, 1].cpu().numpy()
            vals = v.cpu().numpy().astype(np.int64)
        self._dev_bytes -= _entry_dev_bytes(entry)
        self.batches[i][1] = ("kept", (met, rows, cols, vals), entry[2])

    def _maybe_drain(self):
        while (
            self._dev_bytes > self._drain_budget
            and self._drain_ptr < len(self.batches)
        ):
            i = self._drain_ptr
            self._drain_ptr += 1
            if self.batches[i][1][0] == "p2":
                self._compact(i, self.keep_fn)
                self.drained += 1

    def collect_flat(self):
        """Yield (tags, met, rows, cols, vals) per batch, unfiltered."""
        for tags, entry in self.batches:
            if entry[0] == "kept":
                raise RuntimeError(
                    "collect_flat: a batch was compacted by the early drain "
                    "and holds only its filtered matches; collect this runner "
                    "with collect_filtered_metrics/collect_filtered_matches"
                )
            yield (tags, *_entry_to_flat(entry))

    def collect_filtered_metrics(self, keep_fn):
        """Sweep 1: compact every batch not drained yet with ``keep_fn``
        and return [(tags, met)] for every batch. Batches drained during
        dispatch were filtered with the runner's own ``keep_fn``; a
        different filter here would leave them filtered by the wrong
        one, so it raises."""
        if self.drained and keep_fn is not self.keep_fn:
            raise ValueError(
                "collect_filtered_metrics: batches were already drained with "
                "the runner's keep_fn; pass that same function"
            )
        for i in range(len(self.batches)):
            if self.batches[i][1][0] == "p2":
                self._compact(i, keep_fn)
        return [(tags, entry[1][0]) for tags, entry in self.batches]

    def collect_filtered_matches(self):
        """Sweep 2: yield (tags, rows, cols, vals) per batch, restricted
        to kept pairs (rows batch-local ascending, path order)."""
        batches, self.batches = self.batches, []
        for tags, entry in batches:
            _met, rows, cols, vals = entry[1]
            yield tags, rows, cols, vals


def align_candidates(
    markers,
    read_id0: np.ndarray,
    read_id1: np.ndarray,
    same_strand: np.ndarray,
    params: AlignParams,
    ds_hash_table: np.ndarray,
    device="cuda",
) -> AlignmentStore:
    """Align all candidate pairs (method 3) and apply the reference's
    acceptance filters (reference: AssemblerAlign.cpp:437-470).

    The first oriented read of each pair is (read_id0, strand 0); the
    second is (read_id1, strand 0) for same-strand candidates and
    (read_id1, strand 1) otherwise (reference: AssemblerAlign.cpp:380-384).
    ``device`` is where the DP runs: "cuda" (the kernels) unless the
    caller asks for "cpu" (the plain version)."""
    device = AK.resolve_device(device)
    n_pairs = read_id0.shape[0]
    or0 = read_id0.astype(np.int64) << 1
    or1 = (read_id1.astype(np.int64) << 1) | (~same_strand).astype(np.int64)

    koff = np.asarray(markers.offsets, np.int64)
    klen = np.diff(koff)
    kmer_flat = markers.kmer_ids.astype(np.int32)
    n_or = markers.oriented_read_count

    # Downsampled markers as one CSR; ds_ord_flat maps each back to its
    # original ordinal (reference: AssemblerAlign3.cpp:76-80).
    prof = StageProf("align")
    ds_threshold = np.uint32(
        min(int(params.downsampling_factor * float(2**32)), 2**32 - 1)
    )
    ds_sel = np.flatnonzero(ds_hash_table[markers.kmer_ids] < ds_threshold)
    orid_of_sel = np.searchsorted(koff, ds_sel, side="right") - 1
    ds_kmer_flat = kmer_flat[ds_sel]
    ds_ord_flat = ds_sel - koff[orid_of_sel]
    ds_len = np.bincount(orid_of_sel, minlength=n_or).astype(np.int64)
    ds_off = np.zeros(n_or + 1, np.int64)
    np.cumsum(ds_len, out=ds_off[1:])

    la_ds = ds_len[or0]
    lb_ds = ds_len[or1]
    run_idx = np.flatnonzero((la_ds > 0) & (lb_ds > 0))
    prof.mark("ds_prep")

    def keep_fn(tags, met):
        return _keep_mask_from_metrics(met, klen[or0[tags]], klen[or1[tags]], params)

    runner = _CsrStreamingRunner(
        kmer_flat, koff, klen, params, device, keep_fn=keep_fn
    )
    if run_idx.shape[0]:
        # Phase 1 aligns the downsampled sequences over the full matrix,
        # j - i in [-LA, LB] (reference: AssemblerAlign3.cpp:96-130).
        widths_ds = la_ds[run_idx] + lb_ds[run_idx] + 1
        bmins_ds = -la_ds[run_idx]
        # Pairs wider than the widest W class are banded on the densest
        # window of exact-match diagonals; pairs without any shared
        # k-mer cannot align and are dropped.
        wide = widths_ds > _W_BUCKETS[-1]
        if wide.any():
            wsel = np.flatnonzero(wide)
            dmin, dmax, has = _dot_diag_band(
                or0[run_idx[wsel]], or1[run_idx[wsel]],
                ds_kmer_flat, ds_off, ds_len,
                max_width=_W_BUCKETS[-1],
            )
            w2 = dmax - dmin + 3
            use = has & (w2 <= _W_BUCKETS[-1])
            bmins_ds[wsel[use]] = dmin[use] - 1
            widths_ds[wsel[use]] = w2[use]
            drop = wsel[~has]
            if drop.shape[0]:
                keep_mask = np.ones(run_idx.shape[0], bool)
                keep_mask[drop] = False
                run_idx = run_idx[keep_mask]
                widths_ds = widths_ds[keep_mask]
                bmins_ds = bmins_ds[keep_mask]
        key_mat = np.stack(
            [
                _bucket_vec(la_ds[run_idx], _LEN_BUCKETS),
                _bucket_vec(lb_ds[run_idx], _LEN_BUCKETS),
                _bucket_vec(widths_ds, _W_BUCKETS),
            ],
            axis=1,
        )
        uk, inv = np.unique(key_mat, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        ds_dev_csr = _DeviceCsr(
            ds_kmer_flat, ds_off, ds_len, device, aux=ds_ord_flat
        )
        ph1 = []
        for ki in range(uk.shape[0]):
            sel = np.flatnonzero(inv == ki)
            idxs = run_idx[sel]
            la_k, lb_k, w_k = (int(x) for x in uk[ki])
            # Centre each pair's band inside the padded width.
            bm = (bmins_ds[sel] - (w_k - widths_ds[sel]) // 2).astype(np.int32)
            pending = _dispatch_csr(
                ds_dev_csr, or0[idxs], or1[idxs], bm, w_k, la_k, lb_k, params,
                band_fused=True,
            )
            lo = 0
            for entry in pending:
                ph1.append((idxs[lo : lo + entry[2]], entry[1]))
                lo += entry[2]
        prof.mark("ph1_dispatch")
        for idx_arr, band_dev in ph1:
            arr = band_dev.cpu().numpy().astype(np.int64)
            prof.mark("ph1_collect", accumulate=True)
            cnt = arr[:, 0]
            bmin = arr[:, 1] - params.band_extend
            bmax = arr[:, 2] + params.band_extend
            # reference: AssemblerAlign3.cpp:233-239
            sel = np.flatnonzero((cnt > 0) & (bmax - bmin <= params.max_band))
            if sel.shape[0]:
                ps = idx_arr[sel]
                runner.add_many(
                    or0[ps], or1[ps], -bmax[sel], bmax[sel] - bmin[sel] + 1, ps
                )
            prof.mark("ph1_bands_ph2_dispatch", accumulate=True)
        del ds_dev_csr, ph1
    runner.flush_all()
    prof.mark("ph2_flush")

    # Phase-2 collection in two sweeps: the metrics first, which size
    # the output CSR, then each batch's kept matches scatter into it.
    met_of = np.zeros((n_pairs, 10), np.int64)
    seen = np.zeros(n_pairs, bool)
    for tags, met in runner.collect_filtered_metrics(keep_fn):
        met_of[tags] = met
        seen[tags] = True
    prof.mark("ph2_metrics")

    full_idx = np.flatnonzero(seen)
    metrics = met_of[full_idx]
    mc = metrics[:, 0]
    first0, last0 = metrics[:, 1], metrics[:, 2]
    first1, last1 = metrics[:, 3], metrics[:, 4]
    omin, omax = metrics[:, 5], metrics[:, 6]
    mskip, mdrift = metrics[:, 7], metrics[:, 8]
    n0 = klen[or0[full_idx]]
    n1 = klen[or1[full_idx]]

    keep = _keep_mask_from_metrics(metrics, n0, n1, params)
    kept_t = np.flatnonzero(keep)
    kept_p = full_idx[kept_t]

    offs = np.zeros(kept_t.shape[0] + 1, np.int64)
    np.cumsum(mc[kept_t], out=offs[1:])
    # Ordinals are uint16 when no oriented read has more than 65,535
    # markers, else uint32 (the stage hash covers the dtype).
    ord_dtype = np.uint16 if int(klen.max(initial=0)) <= 0xFFFF else np.uint32
    ord0 = np.empty(int(offs[-1]), ord_dtype)
    ord1 = np.empty(int(offs[-1]), ord_dtype)
    rank = np.full(n_pairs, -1, np.int64)
    rank[kept_p] = np.arange(kept_p.shape[0])
    for tags, rows, cols, vals in runner.collect_filtered_matches():
        if rows.shape[0] == 0:
            continue
        pr = rank[tags[rows]]
        m = pr >= 0
        if not m.any():
            continue
        starts = np.searchsorted(rows, np.arange(tags.shape[0] + 1))
        within = np.arange(rows.shape[0], dtype=np.int64) - starts[rows]
        pos = offs[pr[m]] + within[m]
        ord0[pos] = cols[m]
        ord1[pos] = vals[m]
    prof.mark("ph2_collect")
    prof.report(extra=f"pairs={n_pairs}")

    return AlignmentStore(
        read_id0=read_id0[kept_p].astype(np.int32),
        read_id1=read_id1[kept_p].astype(np.int32),
        same_strand=same_strand[kept_p].astype(bool),
        marker_count=mc[kept_t].astype(np.int32),
        n_markers0=n0[kept_t].astype(np.int32),
        n_markers1=n1[kept_t].astype(np.int32),
        first0=first0[kept_t].astype(np.int32),
        last0=last0[kept_t].astype(np.int32),
        first1=first1[kept_t].astype(np.int32),
        last1=last1[kept_t].astype(np.int32),
        min_offset=omin[kept_t].astype(np.int32),
        max_offset=omax[kept_t].astype(np.int32),
        max_skip_v=mskip[kept_t].astype(np.int32),
        max_drift_v=mdrift[kept_t].astype(np.int32),
        ord0=ord0,
        ord1=ord1,
        offsets=offs,
    )
