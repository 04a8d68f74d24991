"""The k-mer downsampling hash table: where it is built, its cache, and
the arithmetic of its card kernel (csrc/kmer_table.cu) modelled in numpy.

The kernel itself runs only on a card (tests/test_torch_cuda.py holds it
to ``kmer_downsampling_hash`` bit for bit); here the route is checked with
the card's build function replaced by the host's, and the Assembler's tables
are checked to carry the run's device."""

import os
import sys

import numpy as np
import pytest
import torch

from shasta_tpu_torch.data import kmers as KM
from shasta_tpu_torch.ops import align_kernel as K
from shasta_tpu_torch.pipeline.assemble import Assembler
from shasta_tpu_torch.pipeline.config import AssemblyConfig
from shasta_tpu_torch.utils import synth

M32 = np.uint32(0x5BD1E995)


def model_kernel(ids: np.ndarray, k: int) -> np.ndarray:
    """csrc/kmer_table.cu's arithmetic in uint32 numpy: the reverse
    complement as complement, 32-bit reversal, a swap inside each 2-bit
    pair and a shift; the key id + rc in 64 bits split into its two
    words; MurmurHash2's two blocks and finalizer."""
    x = np.asarray(ids, np.uint32)
    c = ~x
    r = np.zeros_like(c)
    for i in range(32):  # __brev
        r |= ((c >> np.uint32(i)) & np.uint32(1)) << np.uint32(31 - i)
    s = ((r >> np.uint32(1)) & np.uint32(0x55555555)) | ((r & np.uint32(0x55555555)) << np.uint32(1))
    rc = s >> np.uint32(32 - 2 * k)
    key = x.astype(np.uint64) + rc.astype(np.uint64)
    h = np.full(x.shape, np.uint32(13477 ^ 8), np.uint32)
    with np.errstate(over="ignore"):
        for w in ((key & np.uint64(0xFFFFFFFF)).astype(np.uint32), (key >> np.uint64(32)).astype(np.uint32)):
            w = w * M32
            w ^= w >> np.uint32(24)
            w *= M32
            h = (h * M32) ^ w
        h ^= h >> np.uint32(13)
        h *= M32
        h ^= h >> np.uint32(15)
    return h


@pytest.mark.parametrize("k", range(1, 17))
def test_kernel_arithmetic_model_equals_numpy_hash(k):
    """The kernel's register reverse complement and 32-bit MurmurHash2, as
    a numpy model, equal kmer_downsampling_hash at every k the kernel
    takes: every id up to k 6, the first and last ids and 4096 random
    ones past it."""
    n = 1 << (2 * k)
    if k <= 6:
        ids = np.arange(n, dtype=np.uint64)
    else:
        rng = np.random.default_rng(k)
        ids = np.concatenate([np.arange(64), np.arange(n - 64, n),
                              rng.integers(0, n, 4096)]).astype(np.uint64)
    assert np.array_equal(model_kernel(ids, k), KM.kmer_downsampling_hash(ids, k))


@pytest.fixture
def fresh_tables(monkeypatch):
    """An empty table cache and counts from 0; the card's build function replaced
    by the host's, so the "device" route runs without a card."""
    monkeypatch.setattr(KM, "_TABLES", {})
    monkeypatch.setattr(KM, "TABLE_BUILDS", {"device": 0, "host": 0})
    monkeypatch.setattr(KM, "LAST_BUILD", {})
    calls = []

    def on_card(k, device):
        calls.append((k, torch.device(device)))
        return KM.kmer_downsampling_hash(np.arange(1 << (2 * k), dtype=np.uint64), k)

    monkeypatch.setattr(KM, "_table_on_card", on_card)
    return calls


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
def test_table_without_a_card_is_built_on_the_host(fresh_tables, device):
    """A KmerTable with no device, or with the CPU, takes numpy's path."""
    k = 6
    table = KM.KmerTable(k, np.zeros(1 << (2 * k), bool), device=device).downsampling_hash_table()
    assert KM.TABLE_BUILDS == {"device": 0, "host": 1} and fresh_tables == []
    assert KM.LAST_BUILD["k"] == k and KM.LAST_BUILD["path"] == "host"
    assert KM.LAST_BUILD["seconds"] >= 0
    assert np.array_equal(table, KM.kmer_downsampling_hash(np.arange(1 << (2 * k), dtype=np.uint64), k))


@pytest.mark.parametrize("path", ["device", "host"])
def test_table_cache_one_object_per_k_whichever_path_built_it(fresh_tables, path):
    """The first call at a k builds the table on its device's path; every
    later call at that k, on either path, returns that one read-only
    object; a call at another k replaces it."""
    k = 5
    first_dev, other_dev = (torch.device("cuda", 0), None) if path == "device" else (None, "cuda")
    first = KM.downsampling_hash_table(k, first_dev)
    assert KM.TABLE_BUILDS[path] == 1 and sum(KM.TABLE_BUILDS.values()) == 1
    assert fresh_tables == ([(k, torch.device("cuda", 0))] if path == "device" else [])
    assert not first.flags.writeable
    assert KM.downsampling_hash_table(k, other_dev) is first
    assert KM.KmerTable(k, np.zeros(1 << (2 * k), bool), device=other_dev).downsampling_hash_table() is first
    assert sum(KM.TABLE_BUILDS.values()) == 1
    assert KM.downsampling_hash_table(k - 1, first_dev).shape == (1 << (2 * k - 2),)
    again = KM.downsampling_hash_table(k, first_dev)
    assert KM.TABLE_BUILDS[path] == 3 and again is not first
    assert np.array_equal(again, first)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kmer_table_kernel_takes_only_card_tensors(device):
    """The kernel's binding raises on a tensor that is not on a card and
    launches nothing."""
    before = K.KMER_TABLE_LAUNCHES
    with pytest.raises(ValueError, match="on a card"):
        K.kmer_table(torch.empty(16, dtype=torch.int32, device=device), 2)
    assert K.KMER_TABLE_LAUNCHES == before


@pytest.fixture(scope="module")
def reads_fasta(tmp_path_factory):
    d = tmp_path_factory.mktemp("kmers")
    fasta = str(d / "reads.fasta")
    genome = synth.random_genome(6000, seed=71)
    synth.write_fasta(fasta, synth.sample_reads(genome, 12, 1500, seed=72, both_strands=True))
    return fasta


def fake_card(monkeypatch):
    """Let an Assembler be opened on "cuda" without a card: only its
    device is read, nothing runs on it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def small_config(k=6, method=0):
    cfg = AssemblyConfig()
    cfg.reads.min_read_length = 500
    cfg.kmers.k = k
    cfg.kmers.generation_method = method
    return cfg


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("method", [0, 1, 2, 3, 4])
def test_selected_kmer_table_carries_the_run_device(reads_fasta, tmp_path, monkeypatch, method, device):
    """After each k-mer selection method the Assembler's table carries the
    run's device, and the Kmers stage saves no device."""
    if device == "cuda":
        fake_card(monkeypatch)
    cfg = small_config(method=method)
    if method == 3:
        cfg.kmers.file = str(tmp_path / "kmers.txt")
        with open(cfg.kmers.file, "w") as f:
            f.write("ACGTAC\nTTGCAG\n")
    a = Assembler(str(tmp_path / "run"), cfg, device=device)
    a.add_reads([reads_fasta])
    a.select_kmers()
    assert a.kmer_table.device == a.device == torch.device(device)
    assert "device" not in a.kmer_table.arrays()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_attached_kmer_table_carries_the_run_device(reads_fasta, tmp_path, monkeypatch, device):
    """The stage drivers' attach gives the reloaded table its device."""
    run = str(tmp_path / "run")
    a = Assembler(run, small_config(), device="cpu")
    a.add_reads([reads_fasta])
    a.select_kmers()
    if device == "cuda":
        fake_card(monkeypatch)
    scripts = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "shasta_tpu_torch", "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import _common

    b = _common.attach(run, device)
    assert b.kmer_table is not None and b.kmer_table.device == torch.device(device)
    assert np.array_equal(b.kmer_table.is_marker, a.kmer_table.is_marker)
