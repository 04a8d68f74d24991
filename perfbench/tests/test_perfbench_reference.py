"""The plain reference against the program's own pieces, at small sizes:
its hashes, markers, band of shared k-mers and banded DP. (The tests
may import the program; the reference itself does not.)"""

import numpy as np
import pytest
import torch

from perfbench import gen, reference


def test_hashes_equal_the_programs():
    from shasta_tpu_torch.ops import hashing

    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**62, 5000, dtype=np.uint64)
    words = np.stack([(keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                      (keys >> np.uint64(32)).astype(np.uint32)], axis=1)
    assert np.array_equal(reference.murmur64a_u64(keys, 231), hashing.murmur64_features(words, 231))
    assert np.array_equal(reference.murmur2_u64(keys, 13477), hashing.murmur32_u64(keys, 13477))


def test_markers_equal_the_programs():
    from shasta_tpu_torch.data.kmers import select_kmers_random
    from shasta_tpu_torch.data.markers import find_markers
    from shasta_tpu_torch.data.reads import build_read_store
    from shasta_tpu_torch.io.fasta import parse_fasta_bytes

    g = gen.random_genome(20000, seed=5)
    reads = gen.sample_reads_fixed(g, gen.read_lengths(20000, 3.0, 2000, 0.55, 500, 6), seed=6,
                                  error_rate=0.05, mix=(0.2, 0.5, 0.3), homopolymer_bias=0.9)
    fasta = b"".join(b">r%d\n%s\n" % (i, np.frombuffer(b"ACGT", np.uint8)[r].tobytes())
                     for i, r in enumerate(reads))
    store = build_read_store(parse_fasta_bytes(fasta), min_read_length=0)
    mk = find_markers(store, select_kmers_random(10, 0.1, seed=231))
    p = reference.Params(min_read_length=0, k=10, probability=0.1, kmer_seed=231,
                         downsampling_factor=0.1, match=6, mismatch=-1, gap=-1, band_extend=10,
                         max_band=1000, min_aligned_marker_count=20, min_aligned_fraction=0.0,
                         max_skip=60, max_drift=60, max_trim=60)
    ref = reference.Markers({i: reference.rle(r) for i, r in enumerate(reads)}, p)
    for i in range(len(reads)):
        for strand in (0, 1):
            o = 2 * i + strand
            want = mk.kmer_ids[mk.offsets[o]: mk.offsets[o + 1]].astype(np.int64)
            assert np.array_equal(ref.get(i, strand), want)


def test_dot_band_equals_the_programs():
    from shasta_tpu_torch.ops.align import _dot_diag_band

    rng = np.random.default_rng(8)
    for _ in range(20):
        la, lb = rng.integers(1500, 3000, 2)
        a = rng.integers(0, 400, la)
        b = np.concatenate([a[rng.integers(0, 200):], rng.integers(0, 400, rng.integers(0, 900))])
        flat = np.concatenate([a, b]).astype(np.int64)
        off = np.array([0, la, la + b.shape[0]], np.int64)
        lens = np.diff(off)
        dmin, dmax, has = _dot_diag_band(np.array([0]), np.array([1]), flat, off, lens,
                                         max_width=2048)
        got = reference.dot_band(a, b, 2048)
        assert (got is not None) == bool(has[0])
        if got is not None:
            assert got == (int(dmin[0]), int(dmax[0]))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dp_equals_the_programs_plain_dp(seed):
    from shasta_tpu_torch.ops import align_kernel as AK

    rng = np.random.default_rng(seed)
    for W in (16, 64):
        B, LA, LB = 12, 90, 110
        pairs, rows = [], []
        for _ in range(B):
            la, lb = int(rng.integers(0, LA + 1)), int(rng.integers(0, LB + 1))
            a = rng.integers(0, 6, la)
            b = rng.integers(0, 6, lb)
            pairs.append((a, b, int(rng.integers(-la - W, lb + 1)), W))
        got = reference.banded_dp(pairs, 6, -1, -1, "cpu")
        a = torch.full((B, LA), -1, dtype=torch.int32)
        b = torch.full((B, LB), -2, dtype=torch.int32)
        for q, (pa, pb, _bm, _w) in enumerate(pairs):
            a[q, : pa.shape[0]] = torch.from_numpy(pa)
            b[q, : pb.shape[0]] = torch.from_numpy(pb)
        lens = lambda i: torch.tensor([p[i].shape[0] for p in pairs], dtype=torch.int32)
        bm = torch.tensor([p[2] for p in pairs], dtype=torch.int32)
        fused = AK.banded_align_pairs_plain(a, lens(0), b, lens(1), bm, LA=LA, LB=LB, W=W,
                                            match=6, mismatch=-1, gap=-1)
        for q in range(B):
            want = fused[q, 16: 16 + pairs[q][0].shape[0]].numpy()
            assert np.array_equal(got[q], want), (W, q)


def test_dp_mixed_widths_in_one_chunk():
    rng = np.random.default_rng(4)
    pairs = [(rng.integers(0, 5, 60), rng.integers(0, 5, 70), int(rng.integers(-60, 10)), w)
             for w in (8, 32, 17, 64, 5)]
    together = reference.banded_dp(pairs, 6, -1, -1, "cpu")
    alone = [reference.banded_dp([p], 6, -1, -1, "cpu")[0] for p in pairs]
    assert all(np.array_equal(x, y) for x, y in zip(together, alone))


class _Markers:
    """Two oriented reads whose downsampled markers are all of them, so
    that phase 1 takes the band of shared k-mers (la + lb past 2048)."""

    def __init__(self, a, b):
        self.seqs = {0: a, 1: b}

    def get(self, read, _strand):
        return self.seqs[read]

    def downsampled(self, m):
        return np.arange(m.shape[0])


@pytest.mark.parametrize("band", reference.BANDS)
def test_phase_two_width_by_band(band, monkeypatch):
    rng = np.random.default_rng(6)
    a = rng.permutation(4000)[:1100]  # no marker repeats: one diagonal
    b = np.concatenate([a[40:], 4000 + rng.permutation(4000)[:60]])
    p = reference.Params(min_read_length=0, k=10, probability=0.1, kmer_seed=231,
                         downsampling_factor=1.0, match=6, mismatch=-1, gap=-1, band_extend=10,
                         max_band=1000, min_aligned_marker_count=20, min_aligned_fraction=0.0,
                         max_skip=60, max_drift=60, max_trim=60)
    widths = []
    dp = reference.banded_dp

    def recording(pairs, *args):
        widths.append([w for *_x, w in pairs])
        return dp(pairs, *args)

    monkeypatch.setattr(reference, "banded_dp", recording)
    reference.align(_Markers(a, b), [(0, 1, True)], p, "cpu", band=band)
    phase1, phase2 = widths
    assert phase1 == [128]  # the densest window of shared diagonals, its class
    stated = 1 + 2 * p.band_extend  # every match on the one offset 40
    want = {"class": reference.w_class(stated), "stated": stated, "control": 1}
    assert phase2 == [want[band]]
