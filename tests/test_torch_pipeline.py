"""The port's Assembler (device="cpu") against the JAX package's, stage
by stage, on the golden input of tests/golden/mode0_stage_hashes.json.

Comparisons are exact: every array of every stage manifest is equal,
dtype and shape included, and the manifests hash to the pinned values.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from shasta_tpu.pipeline.assemble import Assembler as RefAssembler
from shasta_tpu_torch.data.kmers import KmerTable
from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.data.reads import ReadStore
from shasta_tpu_torch.data.store import RunStore
from shasta_tpu_torch.ops.lowhash import CandidatePairs
from shasta_tpu_torch.pipeline.assemble import Assembler
from shasta_tpu_torch.utils import synth
from tests.torch_common import one_torch_thread  # noqa: F401

from tests.test_assembly_e2e import small_config as ref_small_config

STAGES = ["Reads", "Kmers", "Markers", "AlignmentCandidates", "Alignments"]
GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "mode0_stage_hashes.json"
)


def port_small_config():
    """tests/test_assembly_e2e.py:small_config on the port's config class."""
    from shasta_tpu_torch.pipeline.config import AssemblyConfig

    cfg = AssemblyConfig()
    for section, key in [
        ("reads", "min_read_length"), ("kmers", "k"), ("kmers", "probability"),
        ("min_hash", "hash_fraction"), ("min_hash", "min_hash_iteration_count"),
        ("min_hash", "max_bucket_size"), ("align", "min_aligned_marker_count"),
        ("align", "max_skip"), ("align", "max_drift"), ("align", "max_trim"),
        ("read_graph", "max_alignment_count"), ("marker_graph", "min_coverage"),
    ]:
        ref = getattr(getattr(ref_small_config(), section), key)
        setattr(getattr(cfg, section), key, ref)
    return cfg


def run_six(asm, fasta):
    asm.add_reads([fasta])
    asm.select_kmers()
    asm.find_markers()
    asm.flag_palindromic_reads()
    asm.find_alignment_candidates()
    asm.compute_alignments()


def stage_hashes(run_dir):
    """tests/test_reference_parity.py:_stage_hashes."""
    store = RunStore(run_dir, create=False)
    out = {}
    for stage in sorted(store.stage_names()):
        h = hashlib.sha256()
        arrays = store.load_stage(stage)
        for name in sorted(arrays):
            a = np.ascontiguousarray(arrays[name])
            h.update(name.encode())
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        out[stage] = h.hexdigest()
    return out


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden")
    genome = synth.random_genome(25000, seed=4242)
    reads = synth.sample_reads(genome, 130, 3000, seed=4243, both_strands=True)
    fasta = str(d / "reads.fasta")
    synth.write_fasta(fasta, reads)
    ref = RefAssembler(str(d / "ref"), ref_small_config())
    run_six(ref, fasta)
    port = Assembler(str(d / "port"), port_small_config(), device="cpu")
    run_six(port, fasta)
    with open(GOLDEN) as f:
        pinned = json.load(f)
    return d, ref, port, pinned


def test_six_stages_match_reference_and_golden(golden):
    """All five manifests are equal array by array (dtypes included) to
    the JAX package's and hash to the pinned golden values;
    is_palindromic is equal too."""
    d, ref, port, pinned = golden
    ref_store = RunStore(str(d / "ref"), create=False)
    port_store = RunStore(str(d / "port"), create=False)
    for stage in STAGES:
        ra = ref_store.load_stage(stage)
        pa = port_store.load_stage(stage)
        assert sorted(ra) == sorted(pa), stage
        for name in ra:
            assert pa[name].dtype == ra[name].dtype, (stage, name)
            assert np.array_equal(pa[name], ra[name]), (stage, name)
    hashes = stage_hashes(str(d / "port"))
    for stage in STAGES:
        assert hashes[stage] == pinned[stage], stage
    assert np.array_equal(port.reads.is_palindromic, ref.reads.is_palindromic)
    assert port.candidates.count == 2200 and port.alignments.count == 1992


def test_reattached_to_reference_run_dir(golden):
    """A port Assembler reattached to the JAX-written Data/ (as
    scripts/_common.py:open_run does, by hand) runs compute_alignments
    on the JAX package's own Markers and AlignmentCandidates and
    reproduces the Alignments hash."""
    d, _ref, _port, pinned = golden
    run_dir = str(d / "ref")
    asm = Assembler(run_dir, port_small_config(), device="cpu")
    store = asm.store
    asm.reads = ReadStore.from_arrays(store.load_stage("Reads"))
    asm.kmer_table = KmerTable.from_arrays(store.load_stage("Kmers"))
    asm.markers = MarkerStore.from_arrays(store.load_stage("Markers"))
    asm.candidates = CandidatePairs.from_arrays(
        store.load_stage("AlignmentCandidates")
    )
    store.remove_stage("Alignments")
    asm.compute_alignments()
    assert stage_hashes(run_dir)["Alignments"] == pinned["Alignments"]


def test_mode3_edges_equal_reference(golden):
    """Mode 3's marker-graph edges on the golden run's vertices: strict
    edges only (no secondary edges, no prune), then the strand audit and
    the MarkerGraph manifest, equal array by array to the JAX
    package's."""
    d, ref, port, _pinned = golden
    runs = []
    for asm in (ref, port):
        asm.config.assembly.mode = 3
        asm.create_read_graph()
        asm.create_marker_graph_vertices()
        asm.create_marker_graph_edges()
        runs.append(asm.store.load_stage("MarkerGraph"))
    ra, pa = runs
    assert sorted(pa) == sorted(ra)
    for name in ra:
        assert pa[name].dtype == ra[name].dtype, name
        assert np.array_equal(pa[name], ra[name]), name
    assert port.marker_graph.edge_count > 0
