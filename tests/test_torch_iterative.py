"""The port's iterative assembly and mode-3 graph against the JAX package's.

- ``nw_match_mismatch_batch``, ``score_pseudo_path_batch`` and
  ``score_alignment_pseudo_paths`` on seeded journeys
  (tests/test_iterative.py's inputs and variants);
- ``create_mode3_graph`` and the rest of ``graph/mode3.py`` on the
  marker graph of the mode-0 golden run (tests/golden/
  mode0_stage_hashes.json's input);
- the whole iterative run on tests/test_iterative.py's input (20 kb,
  seed 71, 120 reads of 3 kb, 2 iterations): every stage manifest and
  the FASTA/GFA byte-equal to the JAX package's run.

Comparisons are exact (arrays with their dtypes, float scores by
equality, files byte for byte).
"""

import os

import numpy as np
import pytest

from shasta_tpu.data.markers import MarkerStore as RefMarkerStore
from shasta_tpu.graph import marker_graph as ref_MG
from shasta_tpu.graph import mode3 as ref_M3
from shasta_tpu.pipeline import assemble as ref_assemble
from shasta_tpu.pipeline import iterative as ref_it
from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.data.store import RunStore
from shasta_tpu_torch.graph import marker_graph as MG
from shasta_tpu_torch.graph import mode3 as M3
from shasta_tpu_torch.pipeline import iterative as IT
from shasta_tpu_torch.pipeline.assemble import run_assembly
from shasta_tpu_torch.utils import synth
from tests.test_assembly_e2e import small_config as ref_small_config
from tests.test_torch_pipeline import port_small_config
from tests.torch_common import one_torch_thread  # noqa: F401


def assert_arrays_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype, name
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), name


def journeys_csr(seed):
    """tests/test_iterative.py::test_batched_nw_matches_loop_scoring's
    journeys: ragged lengths 0 to 89 over 12 segment ids, and
    near-duplicates with two substitutions."""
    rng = np.random.default_rng(seed)
    journeys = [rng.integers(0, 12, int(rng.integers(0, 90))).astype(np.int64) for _ in range(40)]
    for t in range(0, 30, 3):
        j = journeys[t].copy()
        if j.shape[0] > 4:
            j[rng.integers(0, j.shape[0], 2)] = rng.integers(0, 12, 2)
        journeys.append(j)
    off = np.zeros(len(journeys) + 1, np.int64)
    np.cumsum([j.shape[0] for j in journeys], out=off[1:])
    flat = np.concatenate(journeys)
    o0 = rng.integers(0, len(journeys), 300)
    o1 = rng.integers(0, len(journeys), 300)
    return journeys, flat, off, o0, o1


@pytest.mark.parametrize("scores", [(1, -1, -1), (2, -3, -1)])
@pytest.mark.parametrize("seed", [11, 12])
def test_nw_match_mismatch_batch_equals_reference(seed, scores):
    journeys, flat, off, o0, o1 = journeys_csr(seed)
    lens = np.diff(off)
    L = int(lens.max())
    a = IT._pad_journeys(flat, off, o0, lens[o0], L, -1)
    b = IT._pad_journeys(flat, off, o1, lens[o1], L, -2)
    assert np.array_equal(a, ref_it._pad_journeys(flat, off, o0, lens[o0], L, -1))
    got = IT.nw_match_mismatch_batch(a, lens[o0], b, lens[o1], *scores)
    want = ref_it.nw_match_mismatch_batch(a, lens[o0], b, lens[o1], *scores)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("msf", [3.0, 0.5])
@pytest.mark.parametrize("seed", [11, 12])
def test_score_pseudo_path_batch_equals_reference(seed, msf):
    journeys, flat, off, o0, o1 = journeys_csr(seed)
    got = IT.score_pseudo_path_batch(flat, off, o0, o1, msf)
    want = ref_it.score_pseudo_path_batch(flat, off, o0, o1, msf)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for t in range(0, 300, 25):
        j0, j1 = journeys[int(o0[t])], journeys[int(o1[t])]
        assert IT.score_alignment_pseudo_paths(j0, j1, msf) == got[t]
        assert ref_it.score_alignment_pseudo_paths(j0, j1, msf) == got[t]


@pytest.fixture(scope="module")
def golden_mode0(tmp_path_factory):
    """The port's mode-0 golden run; its Markers and MarkerGraph stages
    on both packages' classes."""
    d = tmp_path_factory.mktemp("golden")
    fasta = str(d / "reads.fasta")
    genome = synth.random_genome(25000, seed=4242)
    synth.write_fasta(
        fasta, synth.sample_reads(genome, 130, 3000, seed=4243, both_strands=True)
    )
    run_dir = str(d / "run")
    run_assembly([fasta], run_dir, port_small_config(), device="cpu")
    store = RunStore(run_dir, create=False)
    m, g = store.load_stage("Markers"), store.load_stage("MarkerGraph")
    return (
        (MarkerStore.from_arrays(m), MG.MarkerGraph.from_arrays(g)),
        (RefMarkerStore.from_arrays(m), ref_MG.MarkerGraph.from_arrays(g)),
    )


@pytest.mark.parametrize("min_link_coverage", [1, 3])
def test_create_mode3_graph_equals_reference(golden_mode0, min_link_coverage):
    (markers, mg), (ref_markers, ref_mg) = golden_mode0
    got = M3.create_mode3_graph(markers, mg, min_link_coverage=min_link_coverage)
    want = ref_M3.create_mode3_graph(ref_markers, ref_mg, min_link_coverage=min_link_coverage)
    assert got.segment_count > 0 and got.journey_segments.shape[0] > 0
    assert_arrays_equal(got.arrays(), want.arrays())


def test_mode3_graph_passes_equal_reference(golden_mode0, tmp_path):
    """The rest of graph/mode3.py on the same graph: assembly paths, back
    segments, segment clusters and the mode-3 GFA."""
    (markers, mg), (ref_markers, ref_mg) = golden_mode0
    got = M3.create_mode3_graph(markers, mg, min_link_coverage=1)
    want = ref_M3.create_mode3_graph(ref_markers, ref_mg, min_link_coverage=1)
    paths, ref_paths = M3.find_assembly_paths(got), ref_M3.find_assembly_paths(want)
    assert len(paths) == len(ref_paths)
    for p, q in zip(paths, ref_paths):
        assert p.dtype == q.dtype and np.array_equal(p, q)
    assert np.array_equal(M3.flag_back_segments(got), ref_M3.flag_back_segments(want))
    c, rc = M3.cluster_segments(got, mg, markers), ref_M3.cluster_segments(want, ref_mg, ref_markers)
    assert c.dtype == rc.dtype and np.array_equal(c, rc)
    M3.write_mode3_gfa(str(tmp_path / "port.gfa"), got)
    ref_M3.write_mode3_gfa(str(tmp_path / "ref.gfa"), want)
    assert (tmp_path / "port.gfa").read_bytes() == (tmp_path / "ref.gfa").read_bytes()


STAGES = [
    "Reads", "Kmers", "Markers", "AlignmentCandidates", "Alignments",
    "ReadGraph", "MarkerGraph", "AssemblyGraph",
]
OUTPUTS = ["Assembly.fasta", "Assembly.gfa", "Assembly-BothStrands.gfa"]


@pytest.fixture(scope="module")
def iterative_runs(tmp_path_factory):
    """tests/test_iterative.py::test_iterative_pipeline's run on both
    packages."""
    d = tmp_path_factory.mktemp("iterative")
    fasta = str(d / "r.fasta")
    genome = synth.random_genome(20000, seed=71)
    synth.write_fasta(fasta, synth.sample_reads(genome, 120, 3000, seed=72, both_strands=True))
    ref_cfg, cfg = ref_small_config(), port_small_config()
    for c in (ref_cfg, cfg):
        c.assembly.iterative = True
        c.assembly.iterative_iteration_count = 2
    ref_dir, port_dir = str(d / "ref"), str(d / "port")
    ref = ref_assemble.run_assembly([fasta], ref_dir, ref_cfg)
    port = run_assembly([fasta], port_dir, cfg, device="cpu")
    return ref_dir, ref, port_dir, port


@pytest.mark.parametrize("stage", STAGES)
def test_iterative_stage_manifest_equals_reference(iterative_runs, stage):
    ref_dir, _ref, port_dir, _port = iterative_runs
    assert_arrays_equal(
        RunStore(port_dir, create=False).load_stage(stage),
        RunStore(ref_dir, create=False).load_stage(stage),
    )


def test_iterative_outputs_equal_reference(iterative_runs):
    """FASTA/GFA byte-equal, the summary's counts and the stage list
    (both refinement rounds included) equal the JAX package's."""
    ref_dir, ref, port_dir, port = iterative_runs
    for name in OUTPUTS:
        with open(os.path.join(ref_dir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(port_dir, name), "rb") as f:
            assert f.read() == want, name
    assert list(port["stageSeconds"]) == list(ref["stageSeconds"])
    assert "iterativeAssembly-1" in port["stageSeconds"]
    for key in ("alignmentCount", "markerGraphVertexCount", "markerGraphEdgeCount",
                "assembledSegmentCount", "totalAssembledSegmentLength"):
        assert port[key] == ref[key], key
    assert port["totalAssembledSegmentLength"] > 0.8 * 20000
