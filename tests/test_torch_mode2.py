"""The port's mode 2 (phased diploid assembly) against the JAX package's.

Inputs are tests/test_reference_parity.py:_golden_run_mode2's reads (two
15 kb haplotypes, a SNP every 700 bases, 90 + 90 reads of 2.5 kb),
rebuilt with the port's ``utils/synth.py`` from the same seeds:

- ``golden``: its config (``small_config``, mode 2, minEdgeCoverage 3,
  per strand 0, bubble-removal component-size threshold 3); the port's
  run equals all 17 values of tests/golden/mode2_stage_hashes.json;
- ``main_path``: ``Nanopore-Phased-May2022`` with
  tests/test_torch_graph.py's ``MAIN_PATH_OVERRIDES``; every stage
  manifest and every mode-2 output file equal the JAX package's run.

The strict-edge pass, the Bayesian phase model, bubble phasing and the
secondary edges are held to the JAX functions on the same inputs.
Comparisons are exact: arrays with their dtypes and shapes, floats by
equality, files byte for byte.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from shasta_tpu.data.markers import MarkerStore as RefMarkerStore
from shasta_tpu.data.reads import ReadStore as RefReadStore
from shasta_tpu.graph import marker_graph as ref_MG
from shasta_tpu.graph import mode2 as ref_M2
from shasta_tpu.pipeline import assemble as ref_assemble
from shasta_tpu.pipeline.config import AssemblyConfig as RefAssemblyConfig
from shasta_tpu_torch import native
from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.data.reads import ReadStore
from shasta_tpu_torch.data.store import RunStore
from shasta_tpu_torch.graph import marker_graph as MG
from shasta_tpu_torch.graph import mode2 as M2
from shasta_tpu_torch.pipeline.assemble import run_assembly
from shasta_tpu_torch.pipeline.config import AssemblyConfig
from shasta_tpu_torch.pipeline.configurations import get_configuration
from tests.test_reference_parity import MODE2_PINNED_FILES
from tests.test_torch_graph import MAIN_PATH_OVERRIDES
from tests.test_torch_pipeline import port_small_config
from tests.torch_common import (  # noqa: F401
    mode2_golden_config, one_torch_thread, stage_hashes, write_mode2_reads,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mode2_stage_hashes.json")
STAGES = [
    "Reads", "Kmers", "Markers", "AlignmentCandidates", "Alignments",
    "ReadGraph", "MarkerGraph", "AssemblyGraph",
]
# The 13 files of the Detailed/Haploid/Phased family, the two CSVs of
# bubble chains and phasing regions, and write_output's FASTA/GFA.
MODE2_FILES = [
    f"Assembly-{family}{suffix}"
    for family in ("Detailed", "Haploid", "Phased")
    for suffix in (".gfa", ".fasta", ".csv", "-NoSequence.gfa")
] + [
    "Assembly-Phased-Details.csv", "BubbleChains.csv", "PhasingRegions.csv",
    "Assembly.fasta", "Assembly.gfa", "Assembly-BothStrands.gfa",
]


def golden_config():
    return mode2_golden_config(port_small_config())


def phased_config(cls):
    cfg = cls.from_conf_text(get_configuration("Nanopore-Phased-May2022"))
    for section, key, value in MAIN_PATH_OVERRIDES:
        cfg.set(section, key, value)
    return cfg


@pytest.fixture(scope="module")
def reads_fasta(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mode2") / "reads.fasta")
    write_mode2_reads(path)
    return path


@pytest.fixture(scope="module")
def golden_run(reads_fasta, tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("golden") / "run")
    summary = run_assembly([reads_fasta], run_dir, golden_config(), device="cpu")
    return run_dir, summary


@pytest.fixture(scope="module")
def main_path_runs(reads_fasta, tmp_path_factory):
    d = tmp_path_factory.mktemp("main_path")
    ref_dir, port_dir = str(d / "ref"), str(d / "port")
    ref = ref_assemble.run_assembly(
        [reads_fasta], ref_dir, phased_config(RefAssemblyConfig)
    )
    port = run_assembly([reads_fasta], port_dir, phased_config(AssemblyConfig), device="cpu")
    return ref_dir, ref, port_dir, port


def test_golden_run_equals_pinned_values(golden_run):
    """The 8 stage manifests and the 9 pinned output files of the port's
    run hash to tests/golden/mode2_stage_hashes.json's 17 values."""
    run_dir, summary = golden_run
    assert summary["phasedBubbleCount"] >= 3
    got = stage_hashes(run_dir)
    for name in MODE2_PINNED_FILES:
        with open(os.path.join(run_dir, name), "rb") as f:
            got[f"file:{name}"] = hashlib.sha256(f.read()).hexdigest()
    with open(GOLDEN) as f:
        pinned = json.load(f)
    assert len(pinned) == 17
    assert got == pinned


@pytest.mark.parametrize("stage", STAGES)
def test_main_path_stage_manifest_equals_reference(main_path_runs, stage):
    ref_dir, _ref, port_dir, _port = main_path_runs
    ra = RunStore(ref_dir, create=False).load_stage(stage)
    pa = RunStore(port_dir, create=False).load_stage(stage)
    assert sorted(pa) == sorted(ra)
    for name in ra:
        assert pa[name].dtype == ra[name].dtype, name
        assert pa[name].shape == ra[name].shape, name
        assert np.array_equal(pa[name], ra[name]), name


@pytest.mark.parametrize("name", MODE2_FILES)
def test_main_path_file_byte_equal(main_path_runs, name):
    ref_dir, _ref, port_dir, _port = main_path_runs
    with open(os.path.join(ref_dir, name), "rb") as f:
        ref = f.read()
    with open(os.path.join(port_dir, name), "rb") as f:
        assert f.read() == ref


def test_main_path_summary_equals_reference(main_path_runs):
    """Every count of the summary, the mode-2 statistics included, and
    the stage list equal the JAX package's."""
    _ref_dir, ref, _port_dir, port = main_path_runs
    skip = {"peakMemoryUsageKB", "elapsedSeconds", "cpuSeconds",
            "averageCpuUtilization", "stageSeconds"}
    assert sorted(port) == sorted(ref)
    assert {k: v for k, v in port.items() if k not in skip} == {
        k: v for k, v in ref.items() if k not in skip
    }
    assert list(port["stageSeconds"]) == list(ref["stageSeconds"])
    assert "createMarkerGraphEdgesStrict" in port["stageSeconds"]
    assert "assemblyGraph2" in port["stageSeconds"]


@pytest.mark.parametrize("route", ["native"])
def test_strict_edges_both_routes_equal_reference(golden_run, route, monkeypatch):
    """create_marker_graph_edges_strict on the golden run's reads,
    markers and vertices (69,810 intervals) equals the JAX function,
    through the native interval hashes and counting sort (the one
    route; the id keeps its route name)."""
    run_dir, _summary = golden_run
    store = RunStore(run_dir, create=False)
    reads_a = store.load_stage("Reads")
    markers_a = store.load_stage("Markers")
    vertices = {
        k: v for k, v in store.load_stage("MarkerGraph").items()
        if k in ("vertex_table", "vertex_offsets", "vertex_markers", "rc_vertex")
    }
    calls = []
    hashes = native.strict_interval_hashes_native

    def counted(*args, **kwargs):
        calls.append(1)
        return hashes(*args, **kwargs)

    monkeypatch.setattr(native, "strict_interval_hashes_native", counted)
    port_mg = MG.MarkerGraph(**{k: v.copy() for k, v in vertices.items()})
    M2.create_marker_graph_edges_strict(
        ReadStore.from_arrays(reads_a), MarkerStore.from_arrays(markers_a), port_mg,
        min_edge_coverage=3, min_edge_coverage_per_strand=0,
    )
    assert calls == [1]
    ref_mg = ref_MG.MarkerGraph(**{k: v.copy() for k, v in vertices.items()})
    ref_M2.create_marker_graph_edges_strict(
        RefReadStore.from_arrays(reads_a), RefMarkerStore.from_arrays(markers_a), ref_mg,
        min_edge_coverage=3, min_edge_coverage_per_strand=0,
    )
    got, want = port_mg.arrays(), ref_mg.arrays()
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name
    assert port_mg.edge_count > 0


@pytest.mark.parametrize(
    "matrix",
    [[[10, 0], [0, 10]], [[0, 10], [10, 0]], [[5, 5], [5, 5]], [[0, 0], [0, 0]],
     [[7, 1], [0, 3]], [[0, 4], [0, 9]], [[12, 2], [3, 14]]],
)
@pytest.mark.parametrize("epsilon", [0.1, 0.02])
def test_diploid_bayesian_phase_equals_reference(matrix, epsilon):
    m = np.array(matrix)
    assert M2.diploid_bayesian_phase(m, epsilon) == ref_M2.diploid_bayesian_phase(m, epsilon)


def _bubble_chain(mod, seed):
    """tests/test_mode2.py::test_phase_bubbles_chain's three bubbles
    (reads 0-9 on haplotype A, 10-19 on B, the middle bubble flipped),
    and a seeded variant with noise reads on both sides."""
    rng = np.random.default_rng(seed)
    hap_a, hap_b = np.arange(0, 10), np.arange(10, 20)
    bubbles = []
    for i in range(3 if seed == 0 else 6):
        b = mod.Bubble(v0=2 * i, v1=2 * i + 1, branch_edges=(10 * i, 10 * i + 1))
        r0, r1 = (hap_b, hap_a) if i % 2 == 1 else (hap_a, hap_b)
        if seed:
            r0 = np.union1d(r0[rng.random(10) < 0.7], rng.integers(0, 20, 1))
            r1 = np.setdiff1d(r1[rng.random(10) < 0.7], r0)
        b.reads0, b.reads1 = r0.copy(), r1.copy()
        bubbles.append(b)
    return bubbles


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phase_bubbles_equals_reference(seed):
    port, ref = _bubble_chain(M2, seed), _bubble_chain(ref_M2, seed)
    n = M2.phase_bubbles(port, min_log_p=20, min_common_reads=3)
    assert n == ref_M2.phase_bubbles(ref, min_log_p=20, min_common_reads=3)
    assert [(b.phase, b.component) for b in port] == [(b.phase, b.component) for b in ref]
    if seed == 0:
        assert n == 1 and port[1].phase == -port[0].phase == -port[2].phase


def _markers(cls, seqs):
    """tests/test_marker_graph.py:make_markers on either package's class."""
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    return cls(
        k=4,
        kmer_ids=np.concatenate([np.asarray(s, np.uint32) for s in seqs]),
        positions=np.concatenate([3 * np.arange(len(s), dtype=np.uint32) for s in seqs]),
        offsets=offsets,
    )


@pytest.mark.parametrize("aggressive", [False, True])
def test_secondary_edges_equal_reference(aggressive):
    """tests/test_mode2.py::test_secondary_edges_restore_contiguity's
    chain with its middle edge removed: the secondary edges added, and
    every array after, equal the JAX function's."""
    seqs = [[1, 2, 3, 4], [9, 9, 9, 9], [1, 2, 3, 4], [9, 9, 9, 9]]
    u = np.array([0, 1, 2, 3, 13, 14, 15, 12])
    v = np.array([8, 9, 10, 11, 5, 6, 7, 4])
    out = []
    for mg_mod, m2_mod, cls in ((MG, M2, MarkerStore), (ref_MG, ref_M2, RefMarkerStore)):
        m = _markers(cls, seqs)
        mg = mg_mod.create_marker_graph_vertices(m, u, v, min_coverage=2, max_coverage=10)
        mg_mod.create_marker_graph_edges(m, mg)
        mid = np.flatnonzero(mg.source == mg.vertex_table[1])
        mg.removed_tr[mid] = True
        mg.removed_tr[mg.rc_edge[mid]] = True
        n = m2_mod.create_marker_graph_secondary_edges(m, mg, max_skip=10, aggressive=aggressive)
        out.append((n, mg.arrays(), getattr(mg, "is_secondary", None)))
    (n, got, sec), (n_ref, want, sec_ref) = out
    assert n == n_ref and n >= 2
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name
    assert np.array_equal(sec, sec_ref)


def _split_case(reads_cls, markers_cls, mg_cls):
    """tests/test_mode2.py::test_split_secondary_edges_by_fill_sequence's
    secondary edge whose reads carry two fill sequences."""
    def read(fill):
        return np.array([2, 2] + [fill] * 6 + [3, 3], np.uint8)

    reads = reads_cls(
        rle_bases=np.concatenate([read(0), read(0), read(1), read(1)]),
        repeat_counts=np.ones(40, np.uint8),
        offsets=np.arange(0, 41, 10, dtype=np.int64),
        raw_lengths=np.full(4, 10, np.int64),
        names=[f"r{i}" for i in range(4)],
        metadata=[""] * 4,
    )
    markers = markers_cls(
        k=2,
        kmer_ids=np.zeros(16, np.uint32),
        positions=np.tile(np.array([0, 8], np.uint32), 8),
        offsets=np.arange(0, 17, 2, dtype=np.int64),
    )
    mg = mg_cls(
        vertex_table=np.full(16, -1, np.int64),
        vertex_offsets=np.zeros(5, np.int64),
        vertex_markers=np.zeros(0, np.int64),
        rc_vertex=np.array([2, 3, 0, 1], np.int64),
        source=np.array([0, 2], np.int64),
        target=np.array([1, 3], np.int64),
        coverage=np.array([4, 4], np.int32),
        rc_edge=np.array([1, 0], np.int64),
        removed_tr=np.zeros(2, bool),
        pruned=np.zeros(2, bool),
        superbubble=np.zeros(2, bool),
        low_coverage_cross=np.zeros(2, bool),
        interval_offsets=np.array([0, 4, 8], np.int64),
        interval_orid=np.array([0, 2, 4, 6, 1, 3, 5, 7], np.int64),
        interval_ord0=np.zeros(8, np.int32),
        interval_ord1=np.ones(8, np.int32),
    )
    mg.is_secondary = np.array([True, True])
    return reads, markers, mg


@pytest.mark.parametrize("min_coverage", [2, 3])
def test_split_secondary_edges_equals_reference(min_coverage):
    """The secondary-edge split on tests/test_mode2.py's case (error-rate
    threshold 0.2): the same split counts, and every array after equal
    to the JAX function's, at a cluster coverage that keeps both clusters
    (2) and one that keeps neither (3)."""
    r, m, mg = _split_case(ReadStore, MarkerStore, MG.MarkerGraph)
    rr, rm, rmg = _split_case(RefReadStore, RefMarkerStore, ref_MG.MarkerGraph)
    got = M2.split_marker_graph_secondary_edges(r, m, mg, 0.2, min_coverage)
    assert got == ref_M2.split_marker_graph_secondary_edges(rr, rm, rmg, 0.2, min_coverage)
    if min_coverage == 2:
        assert got == (2, 4)
    want = rmg.arrays()
    assert sorted(mg.arrays()) == sorted(want)
    for name, arr in mg.arrays().items():
        assert arr.dtype == want[name].dtype, name
        assert np.array_equal(arr, want[name]), name
