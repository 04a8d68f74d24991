"""The port's mode 3 (segments, links, the Jaccard graph and its paths)
against the JAX package's, and its PathGraph.

Inputs, each made with the port's ``utils/synth.py`` from the JAX
tests' seeds and run through both packages' ``run_assembly``
(``device="cpu"`` for the port):

- ``pathgraph``: tests/test_mode3_pathgraph.py::test_pathgraph_on_pipeline_mode3
  (a 20 kb genome, seed 55; 120 reads of 2.5 kb, seed 56; small_config);
- ``pipeline``: tests/test_mode3.py::test_mode3_pipeline (seeds 91 and
  92, 120 reads of 3 kb; small_config);
- ``noisy``: tests/test_mode3.py::test_mode3_jaccard_paths_reconstruct
  (160 reads at 2% error, minHashIterationCount 20), the one of the
  three whose Jaccard graph has edges and paths.

Every stage manifest (MarkerGraph and Mode3 included), the three mode-3
files, every file that write_output writes but the four that hold
timings or name the package, and the eight ``mode3*`` summary values
must equal the JAX package's; so must every PathGraph* file of
``create_mode3_path_graph`` on each run's Mode3 stage. Comparisons are
exact: manifests by tests/test_reference_parity.py:_stage_hashes,
files byte for byte.
"""

import os

import numpy as np
import pytest

from shasta_tpu.data.store import RunStore as RefRunStore
from shasta_tpu.graph import mode3_pathgraph as ref_PG
from shasta_tpu.graph.mode3 import Mode3Graph as RefMode3Graph
from shasta_tpu.pipeline import assemble as ref_assemble
from shasta_tpu.pipeline.config import AssemblyConfig as RefAssemblyConfig
from shasta_tpu_torch.data.store import RunStore
from shasta_tpu_torch.graph import mode3_pathgraph as PG
from shasta_tpu_torch.graph.mode3 import Mode3Graph
from shasta_tpu_torch.pipeline.assemble import run_assembly
from shasta_tpu_torch.pipeline.config import AssemblyConfig
from shasta_tpu_torch.utils import synth
from tests.test_mode3_pathgraph import _journeys_to_csr, _two_haplotype_journeys
from tests.torch_common import SMALL_CONF, one_torch_thread, stage_hashes  # noqa: F401

MODE3_VALUES = [
    "mode3SegmentCount", "mode3LinkCount", "mode3PathCount",
    "mode3JaccardEdgeCount", "mode3JaccardPathCount",
    "mode3JaccardPathTotalLength", "mode3JaccardPathN50", "mode3ClusterCount",
]
# write_output's files with the run's timings (the summaries and the
# performance log) or the package's name (index.html) in them.
NOT_COMPARED = {"AssemblySummary.html", "AssemblySummary.json", "index.html", "performance.log"}
# (genome seed, reads, read length, read seed, error rate, minHashIterationCount)
INPUTS = {
    "pathgraph": (55, 120, 2500, 56, 0.0, None),
    "pipeline": (91, 120, 3000, 92, 0.0, None),
    "noisy": (91, 160, 3000, 92, 0.02, 20),
}


def mode3_config(cls, iterations):
    cfg = cls()
    for section, key, value in SMALL_CONF:
        cfg.set(section, key, value)
    cfg.assembly.mode = 3
    if iterations is not None:
        cfg.min_hash.min_hash_iteration_count = iterations
    return cfg


@pytest.fixture(scope="module", params=sorted(INPUTS))
def runs(request, tmp_path_factory):
    name = request.param
    gseed, n, length, rseed, err, iterations = INPUTS[name]
    d = tmp_path_factory.mktemp(name)
    genome = synth.random_genome(20000, seed=gseed)
    kw = dict(error_rate=err) if err else {}
    fasta = str(d / "reads.fasta")
    synth.write_fasta(
        fasta, synth.sample_reads(genome, n, length, seed=rseed, both_strands=True, **kw)
    )
    ref_dir, port_dir = str(d / "ref"), str(d / "port")
    ref = ref_assemble.run_assembly([fasta], ref_dir, mode3_config(RefAssemblyConfig, iterations))
    port = run_assembly([fasta], port_dir, mode3_config(AssemblyConfig, iterations), device="cpu")
    return name, ref_dir, ref, port_dir, port


def test_stage_manifests_equal_reference(runs):
    _name, ref_dir, _ref, port_dir, _port = runs
    got, want = stage_hashes(port_dir), stage_hashes(ref_dir)
    assert {"MarkerGraph", "Mode3"} <= set(want)
    assert got == want


def test_output_files_equal_reference(runs):
    _name, ref_dir, _ref, port_dir, _port = runs
    names = sorted(
        f for f in os.listdir(ref_dir)
        if os.path.isfile(os.path.join(ref_dir, f)) and f not in NOT_COMPARED
    )
    assert {"Mode3-Assembly.gfa", "JaccardGraphEdges.csv", "Mode3-Paths.fasta",
            "Assembly.fasta", "Assembly.gfa"} <= set(names)
    for f in names:
        with open(os.path.join(ref_dir, f), "rb") as a, open(os.path.join(port_dir, f), "rb") as b:
            assert b.read() == a.read(), f


def test_mode3_summary_values_equal_reference(runs):
    name, _ref_dir, ref, _port_dir, port = runs
    assert {k: port[k] for k in MODE3_VALUES} == {k: ref[k] for k in MODE3_VALUES}
    assert port["mode3SegmentCount"] >= 1
    if name == "noisy":
        assert port["mode3JaccardEdgeCount"] > 0 and port["mode3JaccardPathCount"] > 0


def path_graph_files(pg_module, m3, out_dir):
    os.makedirs(out_dir)
    pg_module.create_mode3_path_graph(m3, out_dir=out_dir)
    names = sorted(os.listdir(out_dir))
    assert names and all(n.startswith("PathGraph") for n in names)
    out = {}
    for n in names:
        with open(os.path.join(out_dir, n), "rb") as f:
            out[n] = f.read()
    return out


def test_path_graph_files_equal_reference(runs, tmp_path):
    """create_mode3_path_graph on each package's Mode3 stage writes the
    same PathGraph* files."""
    _name, ref_dir, _ref, port_dir, _port = runs
    ref_m3 = RefMode3Graph.from_arrays(RefRunStore(ref_dir, create=False).load_stage("Mode3"))
    m3 = Mode3Graph.from_arrays(RunStore(port_dir, create=False).load_stage("Mode3"))
    assert path_graph_files(PG, m3, str(tmp_path / "port")) == path_graph_files(
        ref_PG, ref_m3, str(tmp_path / "ref")
    )


def test_path_graph_on_two_haplotypes_equals_reference(tmp_path):
    """tests/test_mode3_pathgraph.py::test_create_mode3_path_graph_outputs's
    journeys (two paths through a shared middle), whose detangling
    writes the second generation of files too."""

    class M3:
        segment_count = 7

    m3 = M3()
    m3.journey_offsets, m3.journey_segments = _journeys_to_csr(_two_haplotype_journeys())
    got = path_graph_files(PG, m3, str(tmp_path / "port"))
    assert got == path_graph_files(ref_PG, m3, str(tmp_path / "ref"))
    assert "PathGraph-1.gfa" in got


def test_path_graph_classes_equal_reference():
    """The PathGraph's vertices, edges and partition on the two-haplotype
    journeys equal the JAX class's."""
    offsets, flat = _journeys_to_csr(_two_haplotype_journeys())
    pg = PG.PathGraph(7, offsets, flat, partition_max_distance=10)
    ref = ref_PG.PathGraph(7, offsets, flat, partition_max_distance=10)
    pg.partition()
    ref.partition()
    assert [v.path for v in pg.vertices] == [v.path for v in ref.vertices]
    assert pg.edges == ref.edges
    assert np.array_equal(pg.subgraph_of, ref.subgraph_of)
