"""The port's native library (shasta_tpu_torch/native.py) against the JAX
package's numpy path.

The port runs one host implementation per primitive: the native one. Each
case below feeds one entry point, through the port function that calls
it, a seeded input and holds the result to the JAX package's function
with ``shasta_tpu.native.get_lib`` returning None, which sends the JAX
package down its numpy (or Python) path. Where the JAX package gated the
native path by size, the input is above that gate. Outputs are compared
byte for byte, or as a sorted multiset where the order is free.
"""

import os
import types

import numpy as np
import pytest

from shasta_tpu import native as ref_native
from shasta_tpu.consensus import caller as ref_caller
from shasta_tpu.consensus import msa as ref_msa
from shasta_tpu.data import bases as ref_bases
from shasta_tpu.data import rle as ref_rle
from shasta_tpu.data.kmers import reverse_complement_kmers, select_kmers_random
from shasta_tpu.data.markers import MarkerStore as RefMarkerStore
from shasta_tpu.data.markers import find_markers as ref_find_markers
from shasta_tpu.data.reads import ReadStore as RefReadStore
from shasta_tpu.graph import assembly_graph as ref_AG
from shasta_tpu.graph import marker_graph as ref_MG
from shasta_tpu.graph import mode2 as ref_M2
from shasta_tpu.graph import read_graph as ref_RG
from shasta_tpu.io.fasta import parse_fasta_bytes as ref_parse_fasta_bytes
from shasta_tpu.ops import hashing as ref_hashing
from shasta_tpu.ops import palindrome as ref_palindrome
from shasta_tpu_torch import native
from shasta_tpu_torch.consensus import caller, msa
from shasta_tpu_torch.data import rle
from shasta_tpu_torch.data.markers import MarkerStore, find_markers
from shasta_tpu_torch.data.reads import ReadStore
from shasta_tpu_torch.graph import assembly_graph as AG
from shasta_tpu_torch.graph import marker_graph as MG
from shasta_tpu_torch.graph import mode2 as M2
from shasta_tpu_torch.graph import read_graph as RG
from shasta_tpu_torch.io.fasta import parse_fasta_bytes
from shasta_tpu_torch.ops import hashing
from shasta_tpu_torch.ops import palindrome
from shasta_tpu_torch.pipeline.assemble import Assembler
from shasta_tpu_torch.utils import synth
from tests.test_read_graph import make_alignments
from tests.test_torch_pipeline import port_small_config, run_six
from tests.torch_common import one_torch_thread  # noqa: F401


_real_get_lib = ref_native.get_lib


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package with no native library: its numpy path."""
    monkeypatch.setattr(ref_native, "get_lib", lambda: None)


@pytest.fixture(scope="module")
def noisy_run(tmp_path_factory):
    """The port's stages through marker graph edges, on the CPU, for 160
    reads of 3 kb with 2 % errors from a 20 kb genome (k 8, markers at
    0.2: over 2^16 marker intervals, and edges with several distinct
    fill sequences)."""
    d = tmp_path_factory.mktemp("native")
    genome = synth.random_genome(20000, seed=91)
    fasta = str(d / "reads.fasta")
    synth.write_fasta(
        fasta,
        synth.sample_reads(genome, 160, 3000, seed=92, error_rate=0.02, both_strands=True),
    )
    cfg = port_small_config()
    cfg.kmers.probability = 0.2
    cfg.min_hash.min_hash_iteration_count = 20
    asm = Assembler(str(d / "run"), cfg, device="cpu")
    run_six(asm, fasta)
    asm.create_read_graph()
    asm.create_marker_graph_vertices()
    asm.create_marker_graph_edges()
    return asm


def reads_of(lens, seed):
    """Random base codes cut into reads of the given lengths."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int64)
    offsets = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return rng.integers(0, 4, int(offsets[-1])).astype(np.uint8), offsets


def marker_csr(n_reads, seed, lo=0, hi=400):
    """Marker counts per read (both strands alike) and their CSR."""
    rng = np.random.default_rng(seed)
    counts0 = rng.integers(lo, hi, n_reads).astype(np.int64)
    counts = np.repeat(counts0, 2)
    moff = np.zeros(2 * n_reads + 1, np.int64)
    np.cumsum(counts, out=moff[1:])
    return counts0, counts, moff


def unite_input(seed, n_reads=3000, n_al=12000):
    """Markers, a read graph and alignments with ordinal pairs for
    gather_unite_pairs: about 2^21 unite pairs (the JAX package's
    native route began at 2^20)."""
    rng = np.random.default_rng(seed)
    _, counts, moff = marker_csr(n_reads, seed, 60, 400)
    r0 = rng.integers(0, n_reads, n_al)
    r1 = (r0 + rng.integers(1, n_reads, n_al)) % n_reads
    same = rng.integers(0, 2, n_al).astype(bool)
    n_per = rng.integers(0, 2 * 87, n_al).astype(np.int64)
    off = np.zeros(n_al + 1, np.int64)
    np.cumsum(n_per, out=off[1:])
    c0 = np.repeat(counts[2 * r0], n_per)
    c1 = np.repeat(counts[2 * r1 + np.where(same, 0, 1)], n_per)
    ord0 = (rng.random(int(off[-1])) * c0).astype(np.uint32)
    ord1 = (rng.random(int(off[-1])) * c1).astype(np.uint32)
    n_edges = 2 * n_al
    alignments = types.SimpleNamespace(
        read_id0=r0.astype(np.int32), read_id1=r1.astype(np.int32),
        same_strand=same, offsets=off, ord0=ord0, ord1=ord1,
    )
    graph = types.SimpleNamespace(
        edge_count=n_edges,
        crosses_strands=np.repeat(rng.random(n_al) < 0.05, 2),
        inconsistent=np.repeat(rng.random(n_al) < 0.05, 2),
        alignment_id=np.repeat(np.arange(n_al, dtype=np.int64), 2),
    )
    markers = types.SimpleNamespace(
        offsets=moff, total_count=int(moff[-1]), counts=lambda: np.diff(moff)
    )
    is_chimeric = rng.random(n_reads) < 0.02
    return markers, graph, alignments, is_chimeric


def read_graph_input(seed, n_reads=60, n_al=170):
    """A random read graph (both packages' ReadGraph) and its alignments."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_al):
        a, b = rng.choice(n_reads, 2, replace=False)
        rows.append((int(min(a, b)), int(max(a, b)), bool(rng.integers(0, 2)),
                     int(rng.integers(20, 200))))
    al = make_alignments(rows)
    ref = ref_RG.build_read_graph(al, n_reads, np.ones(len(rows), bool))
    port = RG.ReadGraph.from_arrays({k: np.copy(v) for k, v in ref.arrays().items()})
    return ref, port, al


def marker_graph_pair(seed, n_vertices=3000, n_edges=5000, extra=()):
    """A strand-symmetric random marker graph (vertex v's reverse
    complement is v ^ 1), in both packages' MarkerGraph. ``extra``
    (source, target) edges, with vertices from n_vertices up, join the
    random ones with their reverse complements."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n_vertices, n_edges)
    t = (s + rng.integers(1, 12, n_edges)) % n_vertices
    if len(extra):
        s = np.concatenate([s, np.asarray(extra)[:, 0]])
        t = np.concatenate([t, np.asarray(extra)[:, 1]])
        n_vertices = int(max(s.max(), t.max())) // 2 * 2 + 2
    keys = np.unique(np.concatenate([s * n_vertices + t, (t ^ 1) * n_vertices + (s ^ 1)]))
    src, tgt = keys // n_vertices, keys % n_vertices
    keys = keys[src != tgt]
    src, tgt = keys // n_vertices, keys % n_vertices
    rc_edge = np.searchsorted(keys, (tgt ^ 1) * n_vertices + (src ^ 1))
    m = keys.shape[0]
    first = np.minimum(np.arange(m), rc_edge)
    cov = rng.integers(1, 12, m)[first].astype(np.int32)
    skip = rng.integers(1, 160, m)[first]
    ioff = np.zeros(m + 1, np.int64)
    np.cumsum(cov, out=ioff[1:])
    n_iv = int(ioff[-1])
    ord0 = np.zeros(n_iv, np.int32)
    ord1 = np.repeat(skip, cov).astype(np.int32)
    arrays = dict(
        vertex_table=np.zeros(0, np.int64),
        vertex_offsets=np.arange(n_vertices + 1, dtype=np.int64),
        vertex_markers=np.arange(n_vertices, dtype=np.int64),
        rc_vertex=np.arange(n_vertices, dtype=np.int64) ^ 1,
        source=src.astype(np.int64), target=tgt.astype(np.int64), coverage=cov,
        rc_edge=rc_edge.astype(np.int64), removed_tr=np.zeros(m, bool),
        pruned=np.zeros(m, bool), superbubble=np.zeros(m, bool),
        low_coverage_cross=np.zeros(m, bool),
        interval_offsets=ioff, interval_orid=np.zeros(n_iv, np.int64),
        interval_ord0=ord0, interval_ord1=ord1,
    )
    copy = lambda: {k: np.copy(v) for k, v in arrays.items()}  # noqa: E731
    return ref_MG.MarkerGraph(**copy()), MG.MarkerGraph(**copy())


def assert_same(got, want):
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        assert got == want


def assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert_same(got[name], want[name])


# ---------------------------------------------------------------------------
# One case per entry point
# ---------------------------------------------------------------------------


def case_find_markers_native():
    """find_markers over 2^20 + 2^17 RLE bases (the JAX package's gate:
    2^20), short and empty reads among them."""
    lens = np.random.default_rng(1).integers(0, 5000, 450)
    lens[:4] = (0, 3, 9, 10)
    flat, offsets = reads_of(lens, 2)
    assert flat.shape[0] >= 1 << 20
    reads = types.SimpleNamespace(rle_bases=flat, offsets=offsets, read_count=lens.shape[0])
    kt = select_kmers_random(10, 0.1, seed=231)
    got, want = find_markers(reads, kt), ref_find_markers(reads, kt)
    assert_same(
        (got.offsets, got.kmer_ids, got.positions),
        (want.offsets, want.kmer_ids, want.positions),
    )


def case_rle_encode_store_native():
    """The read store's RLE over 2^20 + bases (gate 2^20): runs past 255
    flag their read, an empty read among them."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 1_200_000).astype(np.uint8)
    codes[::7] = codes[1::7][: codes[::7].shape[0]]  # some runs of 2 and more
    codes[5000:5600] = 2  # a run of 600: its read is flagged
    codes[900_000:900_255] = 1  # a run of 255: kept
    offsets = np.array([0, 4000, 4000, 300_000, 800_000, 1_200_000], np.int64)
    assert_same(rle.rle_encode_store(codes, offsets), ref_rle.rle_encode_store(codes, offsets))


def case_parse_fasta_native():
    """FASTA bytes: metadata, wrapped and CRLF lines, a blank line,
    lower case and invalid bases, a line before the first header."""
    reads = [synth.random_genome(int(n), seed=int(n)) for n in (997, 3, 2500, 1)]
    fasta = b"not a header\n" + b"".join(
        b">read-%d some meta %d\n%s\n" % (i, i, ref_bases.decode_to_str(r).encode())
        for i, r in enumerate(reads)
    )
    fasta += b">wrapped x\r\nACGT\r\nacgt\r\n\r\nACNG\n>empty\n>last\nTTTT"
    got, want = parse_fasta_bytes(fasta), ref_parse_fasta_bytes(fasta)
    assert (got.names, got.metadata) == (want.names, want.metadata)
    assert_same(got.offsets, want.offsets)
    assert_same(got.codes, ref_bases.encode_ascii(want.seq_ascii))


def case_murmur64_features_native():
    """MurmurHash64A over 2^15 + rows (gate 2^15), odd and even widths."""
    rng = np.random.default_rng(4)
    for m in (1, 2, 5):
        feats = rng.integers(0, 2**32, (40_000, m), dtype=np.uint32)
        assert_same(hashing.murmur64_features(feats, 0xABCDEF),
                    ref_hashing.murmur64_features(feats, 0xABCDEF))


def palindrome_markers(seed, n_reads=300, k=10):
    """Markers of random reads, one in three palindromic (its second half
    the reverse complement of its first), in both packages' MarkerStore."""
    rng = np.random.default_rng(seed)
    counts0 = rng.integers(0, 600, n_reads).astype(np.int64)
    counts0[::3] &= ~np.int64(1)
    ids = []
    for r, c in enumerate(counts0):
        half = rng.integers(0, 4**k, c // 2 if r % 3 == 0 else c).astype(np.uint32)
        s0 = np.concatenate([half, reverse_complement_kmers(half, k)[::-1]]) if r % 3 == 0 else half
        ids += [s0, reverse_complement_kmers(s0, k)[::-1]]
    kmer_ids = np.concatenate(ids).astype(np.uint32)
    moff = np.zeros(2 * n_reads + 1, np.int64)
    np.cumsum(np.repeat(counts0, 2), out=moff[1:])
    a = dict(k=np.int64(k), kmer_ids=kmer_ids,
             positions=np.zeros(kmer_ids.shape[0], np.uint32), offsets=moff)
    return RefMarkerStore.from_arrays(a), MarkerStore.from_arrays(a), counts0


def case_palindrome_keys_native():
    """The palindrome pre-filter's keys, as a sorted multiset (the JAX
    package's numpy form writes them in another order)."""
    ref_ms, ms, counts0 = palindrome_markers(5)
    n_reads = counts0.shape[0]
    d = 37
    max_bucket = int(counts0.max()) // d + 2
    bucket_bits = int(max_bucket).bit_length() + 1
    cum0 = np.zeros(n_reads + 1, np.int64)
    np.cumsum(counts0, out=cum0[1:])
    got = native.palindrome_keys_native(
        ms.kmer_ids, ms.offsets, cum0, n_reads, ms.k, d, max_bucket,
        22, 1 + 22, 1 + 22 + bucket_bits, int(counts0.sum()),
    )
    want = ref_palindrome._prefilter_keys_numpy(
        ref_ms, ref_ms.offsets, counts0, n_reads, 2 * n_reads, int(counts0.sum()), d,
        max_bucket, 22, bucket_bits,
    )
    assert_same(np.sort(got), np.sort(want))


class _Recorder:
    """Stands in for the align runner: records the reads that pass the
    pre-filter and aligns none."""

    def __init__(self, seen):
        self.seen = seen

    def add_many(self, a, b, band_mins, widths, tags):
        self.seen.append(np.asarray(tags).copy())

    def flush_all(self):
        pass

    def collect_flat(self):
        return []


class _BincountRecorder:
    """numpy for the JAX package's palindrome module, recording what
    bincount returns: its group scan's last step is one bincount."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(np, name)

    def bincount(self, *args, **kwargs):
        out = np.bincount(*args, **kwargs)
        self.seen.append(out.astype(np.int64))
        return out


def case_palindrome_scan_native(monkeypatch):
    """flag_palindromic_reads' pre-filter: the group scan over the sorted
    keys gives each read's bound (compared whole), and the reads that
    pass it."""
    ref_ms, ms, _ = palindrome_markers(6)
    got, want, got_tags, want_tags = [], [], [], []
    scan = native.palindrome_scan_native
    monkeypatch.setattr(native, "palindrome_scan_native",
                        lambda *a: got.append(scan(*a)) or got[-1])
    monkeypatch.setattr(ref_palindrome, "np", _BincountRecorder(want))
    monkeypatch.setattr(palindrome, "_CsrStreamingRunner", lambda *a, **k: _Recorder(got_tags))
    monkeypatch.setattr(ref_palindrome, "_CsrStreamingRunner",
                        lambda *a, **k: _Recorder(want_tags))
    palindrome.flag_palindromic_reads(ms, delta_threshold=37, device="cpu")
    ref_palindrome.flag_palindromic_reads(ref_ms, delta_threshold=37)
    assert len(got) == len(want) == 1 and got[0].max() > 0
    assert_same(got, want)
    assert_same(got_tags, want_tags)


def case_expand_unite_pairs_native():
    """gather_unite_pairs over about 2^21 pairs (gate 2^20), as a sorted
    multiset of (u, v): the native pass puts each pair beside its
    reverse complement."""
    markers, graph, al, chim = unite_input(7)
    gu, gv = MG.gather_unite_pairs(markers, graph, al, chim)
    wu, wv = ref_MG.gather_unite_pairs(markers, graph, al, chim)
    assert gu.shape[0] >= 1 << 20
    assert_same((gu.dtype, gv.dtype), (wu.dtype, wv.dtype))
    assert_same(np.sort(gu * markers.total_count + gv), np.sort(wu * markers.total_count + wv))


def case_unite_from_alignments_native():
    """The streamed unite: the labels of the pairs' union-find."""
    markers, graph, al, chim = unite_input(8)
    got = MG.union_find_labels_from_alignments(markers, graph, al, chim)
    want = ref_MG.union_find_labels(
        markers.total_count, *ref_MG.gather_unite_pairs(markers, graph, al, chim))
    assert_same(got, want)


def case_union_find_min_labels_native():
    """union_find_labels over 2^20 + pairs (gate 2^20)."""
    rng = np.random.default_rng(9)
    n = 1_500_000
    u, v = rng.integers(0, n, 1_200_000), rng.integers(0, n, 1_200_000)
    assert_same(MG.union_find_labels(n, u, v), ref_MG.union_find_labels(n, u, v))


def case_transitive_reduction_bfs_native():
    """transitive_reduction's BFS phase on a strand-symmetric graph."""
    ref_mg, mg = marker_graph_pair(10)
    for g, tr in ((mg, MG.transitive_reduction), (ref_mg, ref_MG.transitive_reduction)):
        tr(g, low_coverage_threshold=1, high_coverage_threshold=9, max_distance=6,
           edge_marker_skip_threshold=100)
    assert 0 < mg.removed_tr.sum() < mg.edge_count
    assert_same(mg.removed_tr, ref_mg.removed_tr)


def case_flag_chimeric_native():
    """flag_chimeric_reads at distances 1 to 3."""
    ref_g, g, _ = read_graph_input(11)
    flagged = 0
    for d in (1, 2, 3):
        got = RG.flag_chimeric_reads(g, 60, d)
        assert_same(got, ref_RG.flag_chimeric_reads(ref_g, 60, d))
        flagged += int(got.sum())
    assert flagged > 0


def case_near_strand_jump_native():
    """Strand separation method 1, whose first phase is the native
    near-strand-jump search: the flags and their count."""
    ref_g, g, al = read_graph_input(12, n_al=150)
    for d in (2, 4, 6):
        n_got = RG.flag_cross_strand_edges1(g, al, 60, d)
        n_want = ref_RG.flag_cross_strand_edges1(ref_g, al, 60, d)
        assert n_got == n_want
        assert_same(g.crosses_strands, ref_g.crosses_strands)


def case_cross_strand_edges2_native():
    """Strand separation method 2's DSU sweep."""
    ref_g, g, al = read_graph_input(13, n_al=200)
    chim = np.zeros(60, bool)
    chim[::17] = True
    assert RG.flag_cross_strand_edges2(g, al, 60, chim) == ref_RG.flag_cross_strand_edges2(
        ref_g, al, 60, chim) > 0
    assert_same(g.crosses_strands, ref_g.crosses_strands)


def case_poa_msa_native(monkeypatch):
    """poa_msa on variants of one sequence, most frequent first. The JAX
    package has no numpy POA (with no library it runs a center-star MSA,
    another algorithm), so this case holds the port to the JAX package's
    native POA, the JAX side checked to have loaded it."""
    monkeypatch.setattr(ref_native, "get_lib", _real_get_lib)
    rng = np.random.default_rng(14)
    for _ in range(20):
        root = rng.integers(0, 4, int(rng.integers(20, 300))).astype(np.uint8)
        seqs = []
        for _ in range(int(rng.integers(2, 12))):
            s = root.copy()
            for _ in range(int(rng.integers(0, 8))):
                pos = int(rng.integers(0, s.shape[0]))
                op = int(rng.integers(0, 3))
                if op == 0:
                    s[pos] = rng.integers(0, 4)
                elif op == 1:
                    s = np.insert(s, pos, rng.integers(0, 4)).astype(np.uint8)
                elif s.shape[0] > 1:
                    s = np.delete(s, pos)
            seqs.append(s)
        assert ref_native.available()
        assert_same(msa.poa_msa(seqs), ref_msa.poa_msa(seqs))


def case_edge_consensus_batch_native(run, monkeypatch):
    """assemble_marker_graph_edges on a real marker graph: the port's
    native batch against the JAX package's numpy batch of one-sequence
    edges and its per-edge loop (the JAX side keeps its native POA,
    which the loop calls; only its batch entry is taken away)."""
    monkeypatch.setattr(ref_native, "get_lib", _real_get_lib)
    monkeypatch.setattr(ref_native, "edge_consensus_batch_native", lambda *a, **k: None)
    poa_calls = []
    ref_poa = ref_msa.poa_msa
    monkeypatch.setattr(ref_msa, "poa_msa", lambda seqs: poa_calls.append(1) or ref_poa(seqs))
    arrays = {k: np.copy(v) for k, v in run.marker_graph.arrays().items()}
    reads_a, markers_a = run.reads.arrays(), run.markers.arrays()
    for spec in ("Modal", "Median", "Bayesian:guppy-5.0.7-b"):
        got = AG.assemble_marker_graph_edges(
            ReadStore.from_arrays(reads_a), MarkerStore.from_arrays(markers_a),
            MG.MarkerGraph.from_arrays(arrays), caller=caller.get_consensus_caller(spec))
        want = ref_AG.assemble_marker_graph_edges(
            RefReadStore.from_arrays(reads_a), RefMarkerStore.from_arrays(markers_a),
            ref_MG.MarkerGraph.from_arrays(arrays),
            caller=ref_caller.get_consensus_caller(spec))
        assert_same_arrays(got.arrays(), want.arrays())
    assert len(poa_calls) > 0  # edges whose fill sequences differ


def case_strict_interval_hashes_native(run):
    """create_marker_graph_edges_strict on the real vertices, over 2^16
    marker intervals (the JAX package's gate)."""
    vt = run.marker_graph.vertex_table
    valid = np.flatnonzero(vt >= 0)
    orid = np.searchsorted(run.markers.offsets, valid, side="right") - 1
    assert int((orid[1:] == orid[:-1]).sum()) >= 1 << 16
    vertices = {k: np.copy(v) for k, v in run.marker_graph.arrays().items()
                if k in ("vertex_table", "vertex_offsets", "vertex_markers", "rc_vertex")}
    reads_a, markers_a = run.reads.arrays(), run.markers.arrays()
    got = MG.MarkerGraph(**{k: np.copy(v) for k, v in vertices.items()})
    want = ref_MG.MarkerGraph(**{k: np.copy(v) for k, v in vertices.items()})
    M2.create_marker_graph_edges_strict(
        ReadStore.from_arrays(reads_a), MarkerStore.from_arrays(markers_a), got,
        min_edge_coverage=3, min_edge_coverage_per_strand=0)
    ref_M2.create_marker_graph_edges_strict(
        RefReadStore.from_arrays(reads_a), RefMarkerStore.from_arrays(markers_a), want,
        min_edge_coverage=3, min_edge_coverage_per_strand=0)
    assert got.edge_count > 0
    assert_same_arrays(got.arrays(), want.arrays())


def case_condense_chains_native():
    """create_assembly_graph on seeded strand-symmetric graphs: random
    branching edges, a fifth of them dead (each with its reverse
    complement), beside a self-complementary path, a self-complementary
    cycle and a cycle with its reverse complement; then with one edge's
    reverse complement missing (-1), and with no edge alive. Odd seeds
    hold source, target and rc_edge in int32, as the pipeline's marker
    graph does; even seeds in int64."""
    n_v = 400
    fixed = np.array([
        (0, 2), (2, 3), (3, 1),  # its own reverse complement
        (4, 5), (5, 6), (6, 7), (7, 4),  # a cycle, its own too
        (8, 10), (10, 12), (12, 8),  # a cycle; 13 -> 11 -> 9 -> 13
    ]) + n_v
    for seed in range(4):
        ref_mg, mg = marker_graph_pair(20 + seed, n_v, 300, extra=fixed)
        if seed % 2:
            for g in (mg, ref_mg):
                g.source, g.target, g.rc_edge = (
                    a.astype(np.int32) for a in (g.source, g.target, g.rc_edge))
        dead = (np.random.default_rng(seed).random(mg.edge_count) < 0.2) & (mg.source < n_v)
        dead |= dead[mg.rc_edge]
        variants = [dead, np.ones(mg.edge_count, bool)]
        for i, pruned in enumerate(variants):
            for g in (mg, ref_mg):
                g.pruned[:] = pruned
            got = AG.create_assembly_graph(mg)
            assert_same_arrays(got.arrays(), ref_AG.create_assembly_graph(ref_mg).arrays())
            if i == 1:
                assert got.edge_count == 0
                continue
            alive = mg.alive()
            own = got.rc_edge == np.arange(got.edge_count)
            assert 0 < alive.sum() < mg.edge_count
            assert (np.bincount(mg.source[alive]) > 1).any()
            assert (own & got.is_circular).any() and (own & ~got.is_circular).any()
            assert (~own & got.is_circular).any() and (~own & ~got.is_circular).any()
            assert got.chains.shape[0] == alive.sum()
        for g in (mg, ref_mg):
            g.pruned[:] = dead
            g.rc_edge[np.flatnonzero(~dead)[seed]] = -1
        assert_same_arrays(AG.create_assembly_graph(mg).arrays(),
                           ref_AG.create_assembly_graph(ref_mg).arrays())


def case_counting_sort_by_key_native():
    """The stable counting sort equals the JAX package's stable argsort,
    on dense keys and on keys with more bins than four a key (where the
    JAX package sorted with numpy)."""
    rng = np.random.default_rng(15)
    for n_bins, n in ((500, 200_000), (1_000_000, 20_000)):
        key = rng.integers(0, n_bins, n).astype(np.int64)
        starts = np.zeros(n_bins, np.int64)
        np.cumsum(np.bincount(key, minlength=n_bins)[:-1], out=starts[1:])
        assert_same(native.counting_sort_by_key_native(key, starts),
                    np.argsort(key, kind="stable"))


def case_counting_sort_by_key32_native():
    """create_marker_graph_vertices then create_marker_graph_edges over
    2^20 + markers (the vertex sort's gate: 2^20), with random unions:
    both group by a dense int32 key with the native counting sort."""
    rng = np.random.default_rng(16)
    counts0, counts, moff = marker_csr(4000, 16, 100, 500)
    a = dict(k=np.int64(10), kmer_ids=np.zeros(int(moff[-1]), np.uint32),
             positions=np.zeros(int(moff[-1]), np.uint32), offsets=moff)
    total = int(moff[-1])
    assert total >= 1 << 20
    u = rng.integers(0, total, total // 2)
    v = np.clip(u + rng.integers(-3000, 3000, u.shape[0]), 0, total - 1)
    got = MG.create_marker_graph_vertices(MarkerStore.from_arrays(a), u, v,
                                          min_coverage=2, max_coverage=40)
    want = ref_MG.create_marker_graph_vertices(RefMarkerStore.from_arrays(a), u, v,
                                               min_coverage=2, max_coverage=40)
    assert_same_arrays(got.arrays(), want.arrays())
    MG.create_marker_graph_edges(MarkerStore.from_arrays(a), got)
    ref_MG.create_marker_graph_edges(RefMarkerStore.from_arrays(a), want)
    assert got.edge_count > 0
    assert_same_arrays(got.arrays(), want.arrays())


CASES = {
    name[len("case_"):]: fn for name, fn in sorted(globals().items())
    if name.startswith("case_")
}


@pytest.mark.parametrize("entry", sorted(CASES))
def test_entry_equals_jax_numpy_path(entry, jax_numpy, request, monkeypatch):
    fn = CASES[entry]
    args = {"run": lambda: request.getfixturevalue("noisy_run"), "monkeypatch": lambda: monkeypatch}
    fn(*(args[a]() for a in fn.__code__.co_varnames[: fn.__code__.co_argcount]))


def test_every_entry_has_a_case():
    entries = {n for n in vars(native) if n.endswith("_native")}
    assert entries == set(CASES)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """With no library built and no g++ on the PATH, get_lib raises and
    names the compiler, on a fresh module state."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SO", str(tmp_path / "libshasta_native.so"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.get_lib()
    assert native._lib is None
    assert not os.path.exists(native._SO)
