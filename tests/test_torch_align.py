"""The port's alignment engine (shasta_tpu_torch.ops.align) against the
JAX package's align_candidates, on the CPU.

Every comparison is exact equality of integer arrays, dtypes included:
the alignment stage is deterministic integer work, so the port must
reproduce the reference's AlignmentStore bit for bit.
"""

import numpy as np
import pytest
import torch

from shasta_tpu.data import bases as RB
from shasta_tpu.data.kmers import select_kmers_random as ref_select_kmers
from shasta_tpu.data.markers import find_markers as ref_find_markers
from shasta_tpu.data.reads import build_read_store as ref_build_read_store
from shasta_tpu.io.fasta import parse_fasta_bytes as ref_parse
from shasta_tpu.ops import align as RA
from shasta_tpu.ops import lowhash as RLH
from shasta_tpu_torch.data.kmers import select_kmers_random
from shasta_tpu_torch.data.markers import find_markers
from shasta_tpu_torch.data.reads import build_read_store
from shasta_tpu_torch.io.fasta import parse_fasta_bytes
from shasta_tpu_torch.ops import align as A
from shasta_tpu_torch.ops import align_kernel as K
from shasta_tpu_torch.ops import lowhash as LH
from shasta_tpu_torch.utils import synth
from tests.torch_common import (  # noqa: F401
    compact_batch, compact_reference, one_torch_thread,
)

LH_PARAMS = dict(
    m=3, hash_fraction=0.05, iteration_count=10, min_frequency=2,
    max_bucket_size=60,
)
ALIGN = dict(min_aligned_marker_count=12, max_skip=60, max_drift=60, max_trim=60)


def _fasta():
    """The input of test_align_pallas.py::test_align_candidates_pallas_matches_jnp."""
    genome = synth.random_genome(6000, seed=17)
    reads = synth.sample_reads(
        genome, 14, 1700, seed=18, error_rate=0.01, both_strands=True
    )
    return b"".join(
        b">r%d\n%s\n" % (i, RB.decode_to_str(r).encode())
        for i, r in enumerate(reads)
    )


@pytest.fixture(scope="module")
def inputs():
    fasta = _fasta()
    kt = select_kmers_random(10, 0.1, seed=231)
    markers = find_markers(
        build_read_store(parse_fasta_bytes(fasta), min_read_length=500), kt
    )
    cand = LH.find_candidates_lowhash(markers, LH.LowHashParams(**LH_PARAMS))
    args = (markers, cand.read_id0, cand.read_id1, cand.same_strand,
            A.AlignParams(**ALIGN), kt.downsampling_hash_table())
    ref_kt = ref_select_kmers(10, 0.1, seed=231)
    ref_markers = ref_find_markers(
        ref_build_read_store(ref_parse(fasta), min_read_length=500), ref_kt
    )
    ref_cand = RLH.find_candidates_lowhash(
        ref_markers, RLH.LowHashParams(**LH_PARAMS)
    )
    ref = RA.align_candidates(
        ref_markers, ref_cand.read_id0, ref_cand.read_id1,
        ref_cand.same_strand, RA.AlignParams(**ALIGN),
        ref_kt.downsampling_hash_table(),
    )
    return args, cand, ref


def _assert_store_equal(got, ref):
    ga, ra = got.arrays(), ref.arrays()
    assert sorted(ga) == sorted(ra)
    for k, v in ra.items():
        assert ga[k].dtype == v.dtype, k
        assert np.array_equal(ga[k], v), k


def test_align_candidates_matches_reference(inputs):
    """Every AlignmentStore array equals the JAX package's, dtypes
    included, with filtering that keeps some pairs and drops others."""
    args, cand, ref = inputs
    got = A.align_candidates(*args, device="cpu")
    assert 0 < ref.count < cand.count
    _assert_store_equal(got, ref)
    assert got.check_strictly_increasing()


def test_streaming_runner_eviction_and_drain(inputs, monkeypatch):
    """With budgets of 0 MiB every dispatched batch is drained during
    dispatch and every class matrix is evicted and rebuilt; with
    4-pair flushes there are many batches. The store is unchanged."""
    args, _cand, ref = inputs
    runners = []

    class Spy(A._CsrStreamingRunner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runners.append(self)

    monkeypatch.setattr(A, "_CsrStreamingRunner", Spy)
    monkeypatch.setattr(A, "_FLUSH_PAIRS", 4)
    monkeypatch.setenv("SHASTA_TORCH_DEVQ_MB", "0")
    monkeypatch.setenv("SHASTA_TORCH_MAT_MB", "0")
    got = A.align_candidates(*args, device="cpu")
    _assert_store_equal(got, ref)
    (runner,) = runners
    assert runner.drained >= 2
    n_classes = len(runner.dev_csr._members)
    assert runner.dev_csr.builds > min(n_classes, 2)


def _small_runner(inputs, keep_fn, flush_pairs, monkeypatch):
    args, cand, _ref = inputs
    markers = args[0]
    koff = np.asarray(markers.offsets, np.int64)
    monkeypatch.setattr(A, "_FLUSH_PAIRS", flush_pairs)
    runner = A._CsrStreamingRunner(
        markers.kmer_ids.astype(np.int32), koff, np.diff(koff),
        A.AlignParams(**ALIGN), "cpu", keep_fn=keep_fn,
    )
    n = min(cand.count, 12)
    or0 = cand.read_id0[:n].astype(np.int64) << 1
    or1 = (cand.read_id1[:n].astype(np.int64) << 1) | (~cand.same_strand[:n])
    runner.add_many(
        or0, or1, np.full(n, -64), np.full(n, 128), np.arange(n)
    )
    runner.flush_all()
    return runner


def keep_all(tags, met):
    return np.ones(tags.shape[0], bool)


def keep_none(tags, met):
    return np.zeros(tags.shape[0], bool)


def test_fault_collect_filter_is_the_one_passed(inputs, monkeypatch):
    """ADVICE.md: the reference's collect_filtered_metrics ignores its
    keep_fn when the runner has one. The port applies the filter it is
    given, and refuses a different filter once batches were drained."""
    runner = _small_runner(inputs, keep_all, 4, monkeypatch)
    assert runner.drained == 0
    metas = runner.collect_filtered_metrics(keep_none)
    assert sum(m.shape[0] for _t, m in metas) == 12
    kept, offs, ord0, ord1, _routes = runner.collect_filtered_matches(np.uint16)
    assert kept.shape[0] == 0 and ord0.shape[0] == ord1.shape[0] == 0
    assert offs.tolist() == [0]

    monkeypatch.setenv("SHASTA_TORCH_DEVQ_MB", "0")
    drained = _small_runner(inputs, keep_all, 4, monkeypatch)
    assert drained.drained > 0
    with pytest.raises(ValueError, match="same function"):
        drained.collect_filtered_metrics(keep_none)


def test_fault_drained_batches_do_not_crash_flat_collect(inputs, monkeypatch):
    """ADVICE.md: drained entries crash the reference's legacy collect
    paths with a TypeError. The port raises a clear error instead, and
    an undrained runner collects every pair."""
    runner = _small_runner(inputs, None, 4, monkeypatch)
    rows_seen = sum(t.shape[0] for t, *_ in runner.collect_flat())
    assert rows_seen == 12

    monkeypatch.setenv("SHASTA_TORCH_DEVQ_MB", "0")
    drained = _small_runner(inputs, keep_all, 4, monkeypatch)
    assert drained.drained > 0
    with pytest.raises(RuntimeError, match="early drain"):
        list(drained.collect_flat())


def test_fault_device_errors_propagate(inputs, monkeypatch):
    """ADVICE.md: the reference's _retire_giant_chunked swallows device
    errors with a bare except. In the port an error raised by the DP
    reaches the caller of align_candidates."""
    args, _cand, _ref = inputs
    calls = []

    def failing(*a, **kw):
        calls.append(kw["LA"])
        raise RuntimeError("simulated device failure")

    monkeypatch.setattr(K, "banded_align_pairs", failing)
    with pytest.raises(RuntimeError, match="simulated device failure"):
        A.align_candidates(*args, device="cpu")
    assert calls


def test_fault_env_budgets_read_per_call_not_baked(inputs, monkeypatch):
    """ADVICE.md: SHASTA_TPU_WAVES is baked into the reference's jit
    cache at first trace. The port's SHASTA_TORCH_WAVES is read on every
    DP call: align_candidates picks it up between two calls in one
    process. Its other environment settings of the alignment engine, the
    class-matrix and device-queue budgets, take effect in every runner,
    not only the first."""
    budgets = []
    for mb in (1, 2):
        monkeypatch.setenv("SHASTA_TORCH_MAT_MB", str(mb))
        monkeypatch.setenv("SHASTA_TORCH_DEVQ_MB", str(3 * mb))
        runner = _small_runner(inputs, None, 4, monkeypatch)
        budgets.append((runner.dev_csr._mat_budget, runner._drain_budget))
    assert budgets == [(1 << 20, 3 << 20), (2 << 20, 6 << 20)]

    args, _cand, ref = inputs
    seen = []
    real = K.resolve_waves

    def spy(waves=None):
        seen.append(real(waves))
        return seen[-1]

    monkeypatch.setattr(K, "resolve_waves", spy)
    for w in ("2", "4"):
        monkeypatch.setenv("SHASTA_TORCH_WAVES", w)
        _assert_store_equal(A.align_candidates(*args, device="cpu"), ref)
        assert seen and set(seen) == {int(w)}
        seen.clear()


@pytest.mark.parametrize("route", ["device", "host", "mixed"])
def test_collect_routes_give_the_reference_store(inputs, monkeypatch, route):
    """With 4-pair flushes (many batches), the kept matches written by
    match_compact's plain version (the device route on the CPU), the
    drained batches' matches scattered on the host (a device-queue
    budget of 0), or both in one call (a budget that drains the oldest
    batches and keeps the rest) give the JAX package's store. COLLECT
    counts each route's batches."""
    args, _cand, ref = inputs
    runners = []

    class Spy(A._CsrStreamingRunner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if route == "mixed":
                self._drain_budget = 32 << 10
            runners.append(self)

        def collect_filtered_metrics(self, keep_fn):
            self.n_batches = len(self.batches)
            return super().collect_filtered_metrics(keep_fn)

    monkeypatch.setattr(A, "_CsrStreamingRunner", Spy)
    monkeypatch.setattr(A, "_FLUSH_PAIRS", 4)
    if route == "host":
        monkeypatch.setenv("SHASTA_TORCH_DEVQ_MB", "0")
    got = A.align_candidates(*args, device="cpu")
    _assert_store_equal(got, ref)
    (runner,) = runners
    assert A.COLLECT["host"] == runner.drained
    assert A.COLLECT["device"] + A.COLLECT["host"] == runner.n_batches > 2
    if route == "device":
        assert A.COLLECT["host"] == 0
    elif route == "host":
        assert A.COLLECT["device"] == 0
    else:
        assert A.COLLECT["device"] > 0 and A.COLLECT["host"] > 0


def test_plain_compact_equals_host_scatter(inputs, monkeypatch):
    """On the fixture, the store's ord0, ord1 and offsets that
    match_compact's plain version writes equal those of the host
    scatter of drained batches, byte for byte; every batch takes the
    device route with no drain and the host route under
    SHASTA_TORCH_DEVQ_MB=0."""
    args, _cand, _ref = inputs
    on_device = A.align_candidates(*args, device="cpu")
    assert A.COLLECT["device"] > 0 and A.COLLECT["host"] == 0
    monkeypatch.setenv("SHASTA_TORCH_DEVQ_MB", "0")
    on_host = A.align_candidates(*args, device="cpu")
    assert A.COLLECT["device"] == 0 and A.COLLECT["host"] > 0
    assert on_device.ord0.shape[0] > 0
    for k in ("ord0", "ord1", "offsets"):
        a, b = getattr(on_device, k), getattr(on_host, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("devq", [None, "0"])
def test_uint32_ordinals_past_the_threshold(inputs, monkeypatch, devq):
    """With the uint16 threshold lowered below the reads' marker counts,
    the store keeps uint32 ordinals, on the device route and on the
    host route, with the reference's values and every other array
    unchanged."""
    args, _cand, ref = inputs
    monkeypatch.setattr(A, "_ORD16_MAX", 10)
    if devq is not None:
        monkeypatch.setenv("SHASTA_TORCH_DEVQ_MB", devq)
    got = A.align_candidates(*args, device="cpu")
    assert got.ord0.dtype == got.ord1.dtype == np.uint32
    assert ref.ord0.dtype == np.uint16
    for k, v in ref.arrays().items():
        if k in ("ord0", "ord1"):
            assert np.array_equal(getattr(got, k), v.astype(np.uint32)), k
        else:
            assert getattr(got, k).dtype == v.dtype and np.array_equal(getattr(got, k), v), k


@pytest.mark.parametrize("keep", ["some", "all", "none"])
@pytest.mark.parametrize("LA,dtype", [(130, np.uint16), (40000, np.uint16), (512, np.uint32)])
def test_match_compact_plain_equals_row_loop(LA, dtype, keep):
    """match_compact on CPU tensors (its plain version) against a numpy
    loop over the rows: rows with no match, kept rows in another order
    than the batch's, values past 32,767 in int16 storage (uint16) and
    past 65,535 (uint32). It writes nothing else and counts no launch."""
    fused, dst, n = compact_batch(24, LA, keep=keep, big=dtype == np.uint32)
    tdt = torch.int16 if dtype == np.uint16 else torch.int32
    ord0 = torch.zeros(n, dtype=tdt)
    ord1 = torch.zeros(n, dtype=tdt)
    before = K.COMPACT_LAUNCHES
    K.match_compact(torch.from_numpy(fused), torch.from_numpy(dst), ord0, ord1)
    want0, want1 = compact_reference(fused, dst, n, dtype)
    assert np.array_equal(ord0.numpy().view(dtype), want0)
    assert np.array_equal(ord1.numpy().view(dtype), want1)
    assert (n > 0) == (keep != "none")
    assert K.COMPACT_LAUNCHES == before
    assert "match_compact" not in K.LAUNCHES


def test_band_reduce_matches_host_mapping():
    """The device-side phase-1 band reduction equals the offsets
    computed on the host from the matched pairs."""
    rng = np.random.default_rng(5)
    B, LA, LB = 6, 16, 16
    mj = np.full((B, LA), -1, np.int32)
    orda = np.sort(rng.integers(0, 500, (B, LA)), axis=1).astype(np.int32)
    ordb = np.sort(rng.integers(0, 500, (B, LB)), axis=1).astype(np.int32)
    for t in range(1, B):
        rows = np.sort(rng.choice(LA, 5, replace=False))
        mj[t, rows] = np.sort(rng.choice(LB, 5, replace=False))
    got = K.band_reduce(
        torch.from_numpy(mj), torch.from_numpy(orda), torch.from_numpy(ordb)
    ).numpy()
    assert got[0, 0] == 0
    for t in range(1, B):
        r = np.flatnonzero(mj[t] >= 0)
        off = orda[t, r].astype(np.int64) - ordb[t, mj[t, r]]
        assert list(got[t]) == [5, off.min(), off.max()]


@pytest.mark.parametrize("k", [6, 10])
def test_downsampling_table_once_per_k_equals_jax(k):
    """The downsampling hash table equals the JAX package's, element for
    element; two tables of one k share one read-only array, and a table
    of another k in between does not change it."""
    from shasta_tpu.data.kmers import KmerTable as RefKmerTable
    from shasta_tpu_torch.data.kmers import KmerTable

    is_marker = np.zeros(1 << (2 * k), bool)
    first = KmerTable(k, is_marker).downsampling_hash_table()
    want = RefKmerTable(k, is_marker).downsampling_hash_table()
    assert first.dtype == want.dtype and np.array_equal(first, want)
    assert KmerTable(k, is_marker.copy()).downsampling_hash_table() is first
    assert not first.flags.writeable
    with pytest.raises(ValueError):
        first[0] = 0
    other = KmerTable(k - 1, np.zeros(1 << (2 * k - 2), bool)).downsampling_hash_table()
    assert other.shape == (1 << (2 * k - 2),)
    assert np.array_equal(KmerTable(k, is_marker).downsampling_hash_table(), want)
