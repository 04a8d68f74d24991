"""The port's grading and analysis modules against the JAX package's:
``utils/accuracy.py`` on the inputs of tests/test_accuracy.py,
``graph/analysis.py`` on those of tests/test_analysis.py and
``io/paf.py`` on the load_paf inputs of tests/test_paf_overlay.py.

Both sides are the same numpy code, so every result is compared
exactly: dicts with ``==`` (float values included), arrays with their
dtypes, and each JAX test's own assertions hold on the port's result.
"""

import numpy as np
import pytest

from shasta_tpu.data import bases as RB
from shasta_tpu.graph import analysis as ref_AN
from shasta_tpu.graph.assembly_graph import AssemblyGraph as RefAssemblyGraph
from shasta_tpu.io import paf as ref_paf
from shasta_tpu.utils import accuracy as ref_AC
from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.graph import analysis as AN
from shasta_tpu_torch.graph import marker_graph as MG
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph
from shasta_tpu_torch.io import paf
from shasta_tpu_torch.utils import accuracy as AC
from tests import synth
from tests.test_analysis import make_simple_mg as ref_simple_mg
from tests.test_paf_overlay import _paf_line


def same(got, want):
    """Equal dicts, with equal key order and value types."""
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]), k
    assert got == want


# ---------------------------------------------------------------------------
# utils/accuracy.py (tests/test_accuracy.py)
# ---------------------------------------------------------------------------


def test_perfect_assembly_scores_cap():
    g = synth.random_genome(200_000, seed=3)
    m = AC.assembly_metrics([g], g, k=21)
    same(m, ref_AC.assembly_metrics([g], g, k=21))
    assert m["qv"] == 90.0 and m["completeness"] == 1.0 and m["misassemblies"] == 0


def test_qv_tracks_error_rate():
    g = synth.random_genome(300_000, seed=4)
    rng = np.random.default_rng(5)
    for rate in (1e-4, 1e-3):
        c = synth.apply_errors_vec(g, rng, rate, mix=(1.0, 0.0, 0.0))
        same(AC.assembly_metrics([c], g, k=21), ref_AC.assembly_metrics([c], g, k=21))


def test_completeness_tracks_fraction_assembled():
    g = synth.random_genome(400_000, seed=6)
    m = AC.assembly_metrics([g[:200_000]], g, k=21)
    same(m, ref_AC.assembly_metrics([g[:200_000]], g, k=21))
    assert 0.45 < m["completeness"] < 0.55


def test_misassembly_detected():
    g = synth.random_genome(500_000, seed=7)
    splice = np.concatenate([g[:100_000], g[300_000:400_000]])
    flip = np.concatenate([g[:100_000], RB.reverse_complement(g[300_000:400_000])])
    clean = g[100_000:250_000]
    for contig, bad in ((clean, False), (splice, True), (flip, True)):
        m = AC.assembly_metrics([contig], g, k=21)
        same(m, ref_AC.assembly_metrics([contig], g, k=21))
        assert (m["misassemblies"] >= 1) == bad


def test_parse_fasta_contigs(tmp_path):
    g = synth.random_genome(5000, seed=8)
    p = str(tmp_path / "a.fasta")
    synth.write_fasta(p, [g[:2000], g[2000:]])
    for got, want in zip(AC.parse_fasta_contigs(p), ref_AC.parse_fasta_contigs(p)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    names, seqs = AC.parse_fasta_named(p)
    ref_names, ref_seqs = ref_AC.parse_fasta_named(p)
    assert names == ref_names and len(seqs) == len(ref_seqs) == 2
    assert all(np.array_equal(a, b) for a, b in zip(seqs, ref_seqs))


def test_diploid_metrics():
    hap_a = synth.random_genome(200_000, seed=9)
    hap_b = hap_a.copy()
    snps = np.arange(350, 200_000, 700)
    hap_b[snps] = (hap_b[snps] + 1) % 4
    union = [hap_a[:50_000], hap_b[50_000:120_000]]
    same(
        AC.assembly_metrics(union, [hap_a, hap_b], k=21),
        ref_AC.assembly_metrics(union, [hap_a, hap_b], k=21),
    )
    cases = [
        [hap_a[:60_000], hap_b[:60_000], RB.reverse_complement(hap_a[100_000:160_000])],
        [np.concatenate([hap_a[:30_000], hap_b[30_000:60_000]])],
        [hap_a[:100_000], hap_b[:100_000]],
    ]
    for contigs in cases:
        same(
            AC.diploid_phasing_metrics(contigs, hap_a, hap_b, k=21),
            ref_AC.diploid_phasing_metrics(contigs, hap_a, hap_b, k=21),
        )


def test_phasing_switch_errors():
    hap_a = synth.random_genome(140_000, seed=19)
    hap_b = hap_a.copy()
    snps = np.arange(350, 140_000, 700)
    hap_b[snps] = (hap_b[snps] + 1) % 4
    one = hap_a.copy()
    one[snps[60]] = hap_b[snps[60]]
    cases = [
        [hap_a.copy(), hap_b.copy()],
        [np.concatenate([hap_a[:50_000], hap_b[50_000:90_000], hap_a[90_000:]])],
        [one],
    ]
    for contigs in cases:
        same(
            AC.phasing_switch_errors(contigs, hap_a, hap_b),
            ref_AC.phasing_switch_errors(contigs, hap_a, hap_b),
        )
    assert AC.phasing_switch_errors(cases[1], hap_a, hap_b)["blockSwitches"] == 2


# ---------------------------------------------------------------------------
# graph/analysis.py (tests/test_analysis.py)
# ---------------------------------------------------------------------------


def simple_mg():
    """tests/test_analysis.py:make_simple_mg on the port's classes: the
    JAX markers' arrays and the same vertex unions."""
    ref_m, ref_mg = ref_simple_mg()
    m = MarkerStore.from_arrays(ref_m.arrays())
    u = np.array([0, 1, 2, 9, 10, 11])
    v = np.array([6, 7, 8, 3, 4, 5])
    mg = MG.create_marker_graph_vertices(m, u, v, min_coverage=2, max_coverage=10)
    return (m, mg), (ref_m, ref_mg)


@pytest.mark.parametrize("orids", [(0, 2), (0, 3), (2, 0), (1, 3)])
def test_induced_alignment(orids):
    (m, mg), (ref_m, ref_mg) = simple_mg()
    got = AN.induced_alignment(m, mg, *orids)
    want = ref_AN.induced_alignment(ref_m, ref_mg, *orids)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    if orids == (0, 2):
        assert np.array_equal(got[0], [0, 1, 2]) and np.array_equal(got[1], [0, 1, 2])


def test_marker_connectivity():
    (m, mg), (ref_m, ref_mg) = simple_mg()
    got = AN.marker_connectivity_pairs(m, mg)
    want = ref_AN.marker_connectivity_pairs(ref_m, ref_mg)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert got[0].shape[0] == 6


def test_compress_assembly_graph():
    kw = dict(
        chain_offsets=np.arange(5, dtype=np.int64),
        chains=np.arange(4, dtype=np.int64),
        rc_edge=np.arange(4, dtype=np.int64),
        source_v=np.array([0, 1, 1, 2], np.int64),
        target_v=np.array([1, 2, 2, 3], np.int64),
        is_circular=np.zeros(4, bool),
    )
    cg = AN.compress_assembly_graph(AssemblyGraph(**kw))
    ref = ref_AN.compress_assembly_graph(RefAssemblyGraph(**kw))
    assert cg.edge_count == ref.edge_count == 1
    for name in vars(ref):
        x, y = getattr(cg, name), getattr(ref, name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        else:
            assert x == y, name
    assert set(cg.members_of(0)) == {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# io/paf.py (tests/test_paf_overlay.py)
# ---------------------------------------------------------------------------


def same_overlaps(got, want):
    for name in ("orid", "region", "start", "stop"):
        x, y = getattr(got, name), getattr(want, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert got.region_names == want.region_names
    assert got.skipped_reads == want.skipped_reads
    assert got.count == want.count
    assert got.overlap_pairs() == want.overlap_pairs()
    assert got.read_pairs() == want.read_pairs()


def test_load_paf_and_overlaps(tmp_path):
    p = tmp_path / "ref.paf"
    p.write_text("\n".join([
        _paf_line("r0", "+", "chr1", 0, 1000),
        _paf_line("r1", "+", "chr1", 500, 1500),
        _paf_line("r2", "-", "chr1", 1400, 2400),
        _paf_line("r3", "+", "chr2", 0, 1000),
        _paf_line("r4", "+", "chr1", 1000, 1400),
        _paf_line("missing", "+", "chr1", 0, 99999),
    ]) + "\n")
    names = ["r0", "r1", "r2", "r3", "r4"]
    ov = paf.load_paf(str(p), names)
    same_overlaps(ov, ref_paf.load_paf(str(p), names))
    assert ov.read_pairs() == {(0, 1), (1, 2), (1, 4)}
    for r in range(5):
        assert ov.intervals_for_read(r) == ref_paf.load_paf(str(p), names).intervals_for_read(r)


def test_load_paf_integer_names(tmp_path):
    p = tmp_path / "ref.paf"
    p.write_text(_paf_line("7", "+", "c", 10, 20) + "\n")
    ov = paf.load_paf(str(p))
    same_overlaps(ov, ref_paf.load_paf(str(p)))
    assert ov.orid.tolist() == [14]


def test_load_paf_rejects_short_lines(tmp_path):
    p = tmp_path / "bad.paf"
    p.write_text("a\tb\tc\n")
    with pytest.raises(ValueError) as got:
        paf.load_paf(str(p))
    with pytest.raises(ValueError) as want:
        ref_paf.load_paf(str(p))
    assert str(got.value) == str(want.value)


def test_min_quality_filter(tmp_path):
    p = tmp_path / "ref.paf"
    p.write_text(
        _paf_line("r0", "+", "c", 0, 10, mapq=0) + "\n"
        + _paf_line("r0", "+", "c", 20, 30, mapq=60) + "\n"
    )
    ov = paf.load_paf(str(p), ["r0"], min_quality=30)
    same_overlaps(ov, ref_paf.load_paf(str(p), ["r0"], min_quality=30))
    assert ov.count == 1 and int(ov.start[0]) == 20
