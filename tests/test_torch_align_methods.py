"""The port's alignment methods 0, 1 and 4 and method 4's grouped route
against the JAX package's, on the same seeded numpy inputs.

- ``dots_between``, methods 0 and 1 and ``align4_bands`` on
  tests/test_align_methods.py's inputs and seeded variants;
- ``_grouped_run`` (method 4's dispatch: (LA, LB, W) classes, band
  centring, padded batches) against the JAX ``_grouped_run``, which runs
  its jnp oracle on the CPU, across the W classes 128, 512 and 2048 and
  LA classes that take both forward bodies on the card;
- ``align_candidates_method4`` on
  test_align_candidates_method4_end_to_end's input, every
  ``AlignmentStore`` array equal;
- methods 0 and 1 through ``align_candidates_method`` on the first 64
  candidates of the golden input, and a whole golden run under
  ``alignMethod`` 4 (its ``Alignments`` manifest and FASTA/GFA).

Comparisons are exact (integer arrays with their dtypes).
"""

import os

import numpy as np
import pytest
import torch

from shasta_tpu.ops import align as ref_align
from shasta_tpu.ops import align_other as ref_other
from shasta_tpu.pipeline import assemble as ref_assemble
from shasta_tpu_torch.data import bases as B
from shasta_tpu_torch.data.kmers import select_kmers_random
from shasta_tpu_torch.data.markers import find_markers
from shasta_tpu_torch.data.reads import build_read_store
from shasta_tpu_torch.data.store import RunStore
from shasta_tpu_torch.io.fasta import parse_fasta_bytes
from shasta_tpu_torch.ops import align as AL
from shasta_tpu_torch.ops import align_kernel as AK
from shasta_tpu_torch.ops import align_other as AO
from shasta_tpu_torch.ops import lowhash as LH
from shasta_tpu_torch.pipeline.assemble import Assembler, run_assembly
from shasta_tpu_torch.utils import synth
from tests.test_assembly_e2e import small_config as ref_small_config
from tests.test_torch_pipeline import port_small_config
from tests.torch_common import GROUPED, grouped_inputs, one_torch_thread  # noqa: F401


def assert_stores_equal(got, want):
    for name, arr in want.arrays().items():
        assert getattr(got, name).dtype == arr.dtype, name
        assert np.array_equal(getattr(got, name), arr), name


def seeded_pair(seed, n=150, shift=20, sub=0.1, alpha=400):
    """b is a shifted copy of a with substitutions, repeated markers
    included (alphabet of ``alpha``)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, alpha, n + shift).astype(np.int32)
    a, b = g[:n].copy(), g[shift:].copy()
    hit = rng.random(b.shape[0]) < sub
    b[hit] = rng.integers(0, alpha, int(hit.sum()))
    return a, b


@pytest.mark.parametrize("cap", [1, 2, 10])
@pytest.mark.parametrize("seed", [None, 5, 6])
def test_dots_between_equals_reference(seed, cap):
    if seed is None:
        a, b = np.array([1, 2, 3, 2, 9]), np.array([2, 3, 7, 2])
    else:
        a, b = seeded_pair(seed, alpha=40)
    got, want = AO.dots_between(a, b, cap), ref_other.dots_between(a, b, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_method0_equals_reference(seed):
    if seed == 0:  # tests/test_align_methods.py::test_method0_chains_increasing
        g = np.random.default_rng(0).integers(0, 5000, 120)
        a, b = g[:100], g[20:]
    else:
        a, b = seeded_pair(seed, alpha=60)
    for skip, drift in ((30, 30), (5, 3)):
        got = AO.align_method0(a, b, max_skip=skip, max_drift=drift)
        want = ref_other.align_method0(a, b, max_skip=skip, max_drift=drift)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    if seed == 0:
        assert np.all(got[0].astype(np.int64) - got[1] == 20)


@pytest.mark.parametrize("seed", [1, 3, 4])
def test_method1_equals_reference(seed):
    if seed == 1:  # tests/test_align_methods.py::test_method1_full_overlap
        g = np.random.default_rng(1).integers(0, 5000, 150)
        a, b = g[:120], g[40:]
    else:
        a, b = seeded_pair(seed, alpha=60)
    got, want = AO.align_method1(a, b), ref_other.align_method1(a, b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0].shape[0] >= 75


def align4_inputs(case):
    rng = np.random.default_rng(3)
    if case == "diagonal":  # tests/test_align_methods.py::test_align4_bands_finds_diagonal
        shared = rng.integers(0, 1 << 28, 600).astype(np.int32)
        lead = rng.integers(1 << 28, 1 << 29, 100).astype(np.int32)
        return shared, np.concatenate([lead, shared])
    if case == "no_matches":
        return np.arange(100, dtype=np.int32), np.arange(1000, 1100, dtype=np.int32)
    if case == "two_bands":  # a repeat: b holds two copies of a's middle
        a = rng.integers(0, 1 << 20, 800).astype(np.int32)
        return a, np.concatenate([a[:500], a[200:800]])
    return seeded_pair(17, n=700, shift=60, sub=0.15, alpha=1 << 16)


@pytest.mark.parametrize("case", ["diagonal", "no_matches", "two_bands", "noisy"])
@pytest.mark.parametrize("cells", [(200, 10, 10, 100), (50, 5, 4, 30)])
def test_align4_bands_equal_reference(case, cells):
    a, b = align4_inputs(case)
    assert AO.align4_bands(a, b, *cells) == ref_other.align4_bands(a, b, *cells)
    if case == "diagonal":
        assert any(lo <= -100 <= hi for lo, hi in AO.align4_bands(a, b, *cells))


def test_grouped_inputs_span_both_bodies():
    """The grouped cases reach every W class, and on the card both
    forward bodies."""
    keys = {
        (AL._bucket(la, AL._LEN_BUCKETS), AL._bucket(w, AL._W_BUCKETS))
        for la, _lb, w, _n in GROUPED
    }
    assert {w for _la, w in keys} == {128, 512, 2048}
    assert {AK.fwd_body(la, w) for la, w in keys} == {"diag", "rows"}


def test_grouped_run_equals_reference():
    """Matches (uint32, path order) and metrics columns 0 to 8 equal the
    JAX ``_grouped_run``'s. The jnp oracle leaves the score (column 9)
    at 0; the port's is the DP's best score, held to the fused output in
    test_grouped_run_centres_bands."""
    a_rows, b_rows, bmins, widths = grouped_inputs()
    params = AL.AlignParams()
    got, met = AL._grouped_run(a_rows, b_rows, bmins, widths, params, device="cpu")
    want, ref_met = ref_align._grouped_run(
        a_rows, b_rows, bmins, widths, ref_align.AlignParams()
    )
    assert len(got) == len(want) == len(a_rows)
    for (g0, g1), (w0, w1) in zip(got, want):
        assert g0.dtype == w0.dtype == np.uint32 and g1.dtype == np.uint32
        assert np.array_equal(g0, w0) and np.array_equal(g1, w1)
    assert met.dtype == ref_met.dtype == np.int64
    assert np.array_equal(met[:, :9], ref_met[:, :9])
    assert (met[:, 0] > 0).all() and (met[:, 9] > 0).all()


def test_grouped_run_centres_bands():
    """A pair whose band sits in a wider class is aligned on the class
    band centred on its own: bm = band_min - (W - width) // 2."""
    a_rows, b_rows, bmins, widths = grouped_inputs()
    i = 3  # width 300 in the W 512 class
    params = AL.AlignParams()
    (r,), met = AL._grouped_run(
        a_rows[i : i + 1], b_rows[i : i + 1], bmins[i : i + 1], widths[i : i + 1],
        params, device="cpu",
    )
    la, lb = a_rows[i].shape[0], b_rows[i].shape[0]
    a = torch.full((1, 512), -1, dtype=torch.int32)
    b = torch.full((1, 512), -2, dtype=torch.int32)
    a[0, :la] = torch.from_numpy(a_rows[i])
    b[0, :lb] = torch.from_numpy(b_rows[i])
    fused = AK.banded_align_pairs(
        a, torch.tensor([la], dtype=torch.int32), b, torch.tensor([lb], dtype=torch.int32),
        torch.tensor([int(bmins[i]) - (512 - 300) // 2], dtype=torch.int32),
        LA=512, LB=512, W=512, match=6, mismatch=-1, gap=-1,
    )
    assert np.array_equal(met[0], fused[0, :10].numpy().astype(np.int64))
    assert np.array_equal(r[0], np.flatnonzero(fused[0, 16:].numpy() >= 0))


def test_grouped_run_empty_and_cuda_without_card():
    got, met = AL._grouped_run([], [], np.zeros(0), np.zeros(0), AL.AlignParams(), device="cpu")
    assert got == [] and met.shape == (0, 10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AL._grouped_run([], [], np.zeros(0), np.zeros(0), AL.AlignParams())


def method4_inputs(pkg):
    """test_align_candidates_method4_end_to_end's input on either
    package: 40 reads of 4 kb from a 20 kb genome, k 8, LowHash
    candidates."""
    genome = synth.random_genome(20000, seed=31)
    reads = synth.sample_reads(genome, 40, 4000, seed=32, both_strands=True)
    fasta = b"".join(
        b">r%d\n%s\n" % (i, B.decode_to_str(r).encode()) for i, r in enumerate(reads)
    )
    if pkg == "ref":
        from shasta_tpu.data.kmers import select_kmers_random as sk
        from shasta_tpu.data.markers import find_markers as fm
        from shasta_tpu.data.reads import build_read_store as brs
        from shasta_tpu.io.fasta import parse_fasta_bytes as pfb
        from shasta_tpu.ops import lowhash as lh
    else:
        sk, fm, brs, pfb, lh = (
            select_kmers_random, find_markers, build_read_store, parse_fasta_bytes, LH,
        )
    markers = fm(brs(pfb(fasta)), sk(8, 0.1, seed=231))
    cand = lh.find_candidates_lowhash(
        markers, lh.LowHashParams(max_bucket_size=60, min_frequency=2)
    )
    return markers, cand


def test_align_candidates_method4_equals_reference():
    markers, cand = method4_inputs("port")
    ref_markers, ref_cand = method4_inputs("ref")
    assert np.array_equal(cand.read_id0, ref_cand.read_id0)
    got = AO.align_candidates_method4(
        markers, cand.read_id0, cand.read_id1, cand.same_strand,
        AL.AlignParams(min_aligned_marker_count=40), device="cpu",
    )
    want = ref_other.align_candidates_method4(
        ref_markers, ref_cand.read_id0, ref_cand.read_id1, ref_cand.same_strand,
        ref_align.AlignParams(min_aligned_marker_count=40),
    )
    assert got.count > 0
    assert_stores_equal(got, want)


@pytest.fixture(scope="module")
def golden_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden")
    fasta = str(d / "reads.fasta")
    genome = synth.random_genome(25000, seed=4242)
    synth.write_fasta(
        fasta, synth.sample_reads(genome, 130, 3000, seed=4243, both_strands=True)
    )
    return fasta


@pytest.mark.parametrize("method", [0, 1])
def test_methods_0_and_1_on_golden_candidates(golden_reads, tmp_path, method):
    """align_candidates_method on the first 64 golden candidates (the
    port's markers and candidates, which equal the pinned hashes): every
    AlignmentStore array equal to the JAX function's."""
    asm = Assembler(str(tmp_path / "run"), port_small_config(), device="cpu")
    asm.add_reads([golden_reads])
    asm.select_kmers()
    asm.find_markers()
    asm.flag_palindromic_reads()
    asm.find_alignment_candidates()
    c = asm.candidates
    params = AL.AlignParams(
        min_aligned_marker_count=20, max_skip=60, max_drift=60, max_trim=60
    )
    ref_params = ref_align.AlignParams(
        min_aligned_marker_count=20, max_skip=60, max_drift=60, max_trim=60
    )
    sel = slice(0, 64)
    got = AO.align_candidates_method(
        asm.markers, c.read_id0[sel], c.read_id1[sel], c.same_strand[sel], params, method
    )
    want = ref_other.align_candidates_method(
        asm.markers, c.read_id0[sel], c.read_id1[sel], c.same_strand[sel],
        ref_params, method,
    )
    assert got.count > 0
    assert_stores_equal(got, want)


def test_method4_golden_run_equals_reference(golden_reads, tmp_path):
    """The whole golden run under alignMethod 4: the Alignments manifest
    equals the JAX package's, and so do Assembly.fasta and Assembly.gfa."""
    ref_cfg, cfg = ref_small_config(), port_small_config()
    ref_cfg.align.align_method = cfg.align.align_method = 4
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = ref_assemble.run_assembly([golden_reads], ref_dir, ref_cfg)
    port = run_assembly([golden_reads], port_dir, cfg, device="cpu")
    assert port["alignmentCount"] == ref["alignmentCount"] > 0
    ra = RunStore(ref_dir, create=False).load_stage("Alignments")
    pa = RunStore(port_dir, create=False).load_stage("Alignments")
    assert sorted(pa) == sorted(ra)
    for name in ra:
        assert pa[name].dtype == ra[name].dtype, name
        assert np.array_equal(pa[name], ra[name]), name
    for name in ("Assembly.fasta", "Assembly.gfa", "Assembly-BothStrands.gfa"):
        with open(os.path.join(ref_dir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(port_dir, name), "rb") as f:
            assert f.read() == want, name
