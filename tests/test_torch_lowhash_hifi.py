"""LowHash on the run's device (``ops/lowhash.py:find_candidates_lowhash``)
at the settings of Shasta's HiFi-Oct2021 and Nanopore-May2022, on the
CPU: against the benchmark's plain reference (``perfbench/
reference_lowhash.py``), against the JAX package's host count, under
the profiler, and a whole HiFi-Oct2021 assembly."""

import os

import numpy as np
import pytest
import torch

from perfbench import gen, reference, reference_lowhash
from shasta_tpu_torch.data.kmers import select_kmers_random
from shasta_tpu_torch.data.markers import find_markers
from shasta_tpu_torch.data.reads import build_read_store
from shasta_tpu_torch.io.fasta import parse_fasta_bytes
from shasta_tpu_torch.ops import lowhash as LH
from tests.torch_common import one_torch_thread  # noqa: F401

_ACGT = np.frombuffer(b"ACGT", np.uint8)

# (LowHash values, read model) of each configuration; k 14, probability
# 0.1 and Kmers.seed 231 in both.
SETTINGS = {
    "HiFi-Oct2021": (
        dict(m=4, hash_fraction=0.05, iteration_count=100, log2_bucket_count=0,
             min_bucket_size=10, max_bucket_size=60, min_frequency=3),
        dict(coverage=30.0, median=17000, sigma=0.15, min_length=8000, error_rate=0.002,
             mix=(0.10, 0.45, 0.45)),
    ),
    "Nanopore-May2022": (
        dict(m=4, hash_fraction=0.01, iteration_count=10, log2_bucket_count=0,
             min_bucket_size=5, max_bucket_size=30, min_frequency=5),
        dict(coverage=25.0, median=25000, sigma=0.55, min_length=10000, error_rate=0.05,
             mix=(0.2, 0.5, 0.3)),
    ),
}


def _reads(model, genome_bases=60000, seed=11):
    g = gen.random_genome(genome_bases, seed)
    lengths = gen.read_lengths(genome_bases, model["coverage"], model["median"], model["sigma"],
                               model["min_length"], seed + 1)
    return gen.sample_reads_fixed(g, lengths, seed=seed + 2, error_rate=model["error_rate"],
                                  mix=model["mix"], homopolymer_bias=0.9)


def _fasta(reads):
    return b"".join(b">r%d\n%s\n" % (i, _ACGT[r].tobytes()) for i, r in enumerate(reads))


def _markers(reads):
    store = build_read_store(parse_fasta_bytes(_fasta(reads)), min_read_length=0)
    return find_markers(store, select_kmers_random(14, 0.1, seed=231))


def _palindromic(n):
    flags = np.zeros(n, bool)
    flags[3] = True
    return flags


def _arrays(c):
    return {k: getattr(c, k) for k in ("read_id0", "read_id1", "same_strand", "frequency")}


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_candidates_equal_the_plain_reference(name):
    """Every candidate and its frequency, at the configuration's LowHash
    values, equal reference_lowhash's, which hashes its own markers."""
    lh, model = SETTINGS[name]
    reads = _reads(model)
    pal = _palindromic(len(reads))
    got = LH.find_candidates_lowhash(_markers(reads), LH.LowHashParams(**lh), pal, device="cpu")
    p = reference.Params(min_read_length=0, k=14, probability=0.1, kmer_seed=231,
                         downsampling_factor=0.05, match=6, mismatch=-1, gap=-1, band_extend=10,
                         max_band=1000, min_aligned_marker_count=0, min_aligned_fraction=0.0,
                         max_skip=0, max_drift=0, max_trim=0)
    mk = reference.Markers({i: reference.rle(r) for i, r in enumerate(reads)}, p)
    rp = reference_lowhash.LowHashParams(
        m=lh["m"], hash_fraction=lh["hash_fraction"], iterations=lh["iteration_count"],
        log2_buckets=lh["log2_bucket_count"], min_bucket_size=lh["min_bucket_size"],
        max_bucket_size=lh["max_bucket_size"], min_frequency=lh["min_frequency"])
    want = reference_lowhash.candidates(mk, len(reads), pal, rp)
    assert got.count > len(reads)
    _assert_equal(_arrays(got), want)
    # A block of reads: the pairs that touch it, and no others.
    block = list(range(0, len(reads), 7))
    part = reference_lowhash.candidates(mk, len(reads), pal, rp, reads=block)
    touch = np.isin(got.read_id0, block) | np.isin(got.read_id1, block)
    _assert_equal({k: v[touch] for k, v in _arrays(got).items()}, part)


@pytest.mark.parametrize("chunks", ["whole", "chunked"])
def test_device_count_equals_the_host_count(chunks, monkeypatch):
    """The device path (CPU tensors) and the JAX package's host count
    (every iteration's pair keys kept, one np.unique at the end) give
    identical CandidatePairs and bucket statistics on the same reads,
    whole or in small chunks of features and pair keys."""
    from shasta_tpu.data.kmers import select_kmers_random as ref_select
    from shasta_tpu.data.markers import find_markers as ref_find_markers
    from shasta_tpu.data.reads import build_read_store as ref_build
    from shasta_tpu.io.fasta import parse_fasta_bytes as ref_parse
    from shasta_tpu.ops import lowhash as RLH

    if chunks == "chunked":
        monkeypatch.setattr(LH, "PAIR_CHUNK", 997)
        monkeypatch.setattr(LH, "FEATURE_CHUNK", 4099)
    lh, model = SETTINGS["HiFi-Oct2021"]
    lh = dict(lh, iteration_count=20)
    reads = _reads(model, genome_bases=40000, seed=21)
    pal = _palindromic(len(reads))
    fasta = _fasta(reads)
    ref_markers = ref_find_markers(ref_build(ref_parse(fasta), min_read_length=0),
                                   ref_select(14, 0.1, seed=231))
    got_stats, want_stats = {}, {}
    got = LH.find_candidates_lowhash(_markers(reads), LH.LowHashParams(**lh), pal, got_stats,
                                     device="cpu")
    want = RLH.find_candidates_lowhash(ref_markers, RLH.LowHashParams(**lh), pal, want_stats)
    assert got.count > 0
    _assert_equal(_arrays(got), _arrays(want))
    assert sorted(got_stats) == sorted(want_stats) == ["bucket_histogram", "read_stats"]
    for k in want_stats:
        assert np.array_equal(got_stats[k], want_stats[k]), k


def test_spans_and_counter_under_the_profiler():
    """The three ``stage:lowhash.*`` spans are in a CPU trace, and
    ``COUNTS`` holds the last call's work alone."""
    lh, model = SETTINGS["Nanopore-May2022"]
    markers = _markers(_reads(model, genome_bases=30000, seed=31))
    params = LH.LowHashParams(**lh)
    LH.find_candidates_lowhash(markers, LH.LowHashParams(**dict(lh, iteration_count=3)))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = LH.find_candidates_lowhash(markers, params, device="cpu")
    names = {e.name for e in prof.events()}
    assert {"stage:lowhash.hash", "stage:lowhash.group", "stage:lowhash.pairs"} <= names
    assert LH.COUNTS["iterations"] == params.iteration_count
    assert LH.COUNTS["candidates"] == got.count > 0
    assert LH.COUNTS["pair_keys"] >= int(got.frequency.sum())


def test_hifi_oct2021_assembles_on_the_cpu(tmp_path):
    """A whole run_assembly under HiFi-Oct2021, its LowHash on CPU
    tensors, at k 10: HiFi's k 14 would make the CPU build the 4^14
    downsampling table (1 GiB, about 35 s) for computeAlignments."""
    from shasta_tpu_torch.pipeline.assemble import run_assembly
    from shasta_tpu_torch.pipeline.config import AssemblyConfig
    from shasta_tpu_torch.pipeline.configurations import CONFIGURATIONS
    from shasta_tpu_torch.utils import synth

    cfg = AssemblyConfig.from_conf_text(CONFIGURATIONS["HiFi-Oct2021"])
    cfg.kmers.k = 10
    genome = synth.random_genome(30000, seed=5)
    fa = os.path.join(tmp_path, "reads.fasta")
    synth.write_fasta(fa, synth.sample_reads(genome, 60, 9000, seed=6, error_rate=0.001,
                                             both_strands=True))
    s = run_assembly([fa], os.path.join(tmp_path, "run"), cfg, device="cpu")
    assert cfg.min_hash.min_hash_iteration_count == 100
    assert cfg.read_graph.creation_method == 0
    assert LH.COUNTS["iterations"] == 100 and LH.COUNTS["candidates"] > 0
    assert s["totalAssembledSegmentLength"] > 21000, s
