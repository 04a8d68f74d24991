"""The port's whole mode-0 ``run_assembly`` (device="cpu") against the JAX
package's, read graph to GFA/FASTA, on the golden input of
tests/golden/mode0_stage_hashes.json.

Two cases on the same reads:

- ``golden``: ``small_config`` (tests/test_assembly_e2e.py), whose
  stage hashes and metrics are pinned in tests/golden/;
- ``main_path``: ``Nanopore-May2022``'s text with only the overrides
  that 3 kb reads of a 25 kb genome force (``MAIN_PATH_OVERRIDES``). It
  runs read graph creation method 2, the peak finder's automatic
  minCoverage, the simplifyMaxLength list, low-coverage cross-edge
  removal, detangle method 2 and the ``Bayesian:guppy-5.0.7-b`` caller.

Comparisons are exact: every array of every stage manifest (dtype and
shape included) and the output files byte for byte.
"""

import json
import os

import numpy as np
import pytest

from shasta_tpu.pipeline import assemble as ref_assemble
from shasta_tpu.pipeline.config import AssemblyConfig as RefAssemblyConfig
from shasta_tpu_torch.data.store import RunStore
from shasta_tpu_torch.pipeline.assemble import run_assembly
from shasta_tpu_torch.pipeline.config import AssemblyConfig
from shasta_tpu_torch.pipeline.configurations import get_configuration
from shasta_tpu_torch.utils import synth
from tests.test_assembly_e2e import small_config as ref_small_config
from tests.test_reference_parity import GOLDEN_KEYS, MODE0_FILE_FAMILY
from tests.test_torch_pipeline import GOLDEN, port_small_config, stage_hashes
from tests.torch_common import one_torch_thread  # noqa: F401

HERE = os.path.dirname(__file__)
METRICS = os.path.join(HERE, "golden", "mode0_metrics.json")
STAGES = [
    "Reads", "Kmers", "Markers", "AlignmentCandidates", "Alignments",
    "ReadGraph", "MarkerGraph", "AssemblyGraph",
]
OUTPUTS = ["Assembly.fasta", "Assembly.gfa", "Assembly-BothStrands.gfa"]
# The small_config keys, the only ones 3 kb reads of a 25 kb genome
# force on Nanopore-May2022 (min read length, k, MinHash sizes, Align
# thresholds, read graph degree).
MAIN_PATH_OVERRIDES = [
    ("Reads", "minReadLength", "500"),
    ("Kmers", "k", "8"),
    ("Kmers", "probability", "0.1"),
    ("MinHash", "hashFraction", "0.05"),
    ("MinHash", "minHashIterationCount", "6"),
    ("MinHash", "maxBucketSize", "60"),
    ("Align", "minAlignedMarkerCount", "20"),
    ("Align", "maxSkip", "60"),
    ("Align", "maxDrift", "60"),
    ("Align", "maxTrim", "60"),
    ("ReadGraph", "maxAlignmentCount", "8"),
]


def main_path_config(cls):
    cfg = cls.from_conf_text(get_configuration("Nanopore-May2022"))
    for section, key, value in MAIN_PATH_OVERRIDES:
        cfg.set(section, key, value)
    return cfg


CONFIGS = {
    "golden": (ref_small_config, port_small_config),
    "main_path": (
        lambda: main_path_config(RefAssemblyConfig),
        lambda: main_path_config(AssemblyConfig),
    ),
}


@pytest.fixture(scope="module")
def reads_fasta(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    genome = synth.random_genome(25000, seed=4242)
    fasta = str(d / "reads.fasta")
    synth.write_fasta(
        fasta, synth.sample_reads(genome, 130, 3000, seed=4243, both_strands=True)
    )
    return fasta


@pytest.fixture(scope="module")
def run_of(reads_fasta, tmp_path_factory):
    """case -> (ref run dir, ref summary, port run dir, port summary),
    each case run once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            ref_cfg, port_cfg = CONFIGS[case]
            d = tmp_path_factory.mktemp(case)
            ref_dir, port_dir = str(d / "ref"), str(d / "port")
            ref = ref_assemble.run_assembly([reads_fasta], ref_dir, ref_cfg())
            port = run_assembly([reads_fasta], port_dir, port_cfg(), device="cpu")
            cache[case] = (ref_dir, ref, port_dir, port)
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(CONFIGS))
@pytest.mark.parametrize("stage", STAGES)
def test_stage_manifest_equals_reference(run_of, case, stage):
    """Each of the eight stage manifests is equal to the JAX package's,
    array by array, dtypes included."""
    ref_dir, _ref, port_dir, _port = run_of(case)
    ra = RunStore(ref_dir, create=False).load_stage(stage)
    pa = RunStore(port_dir, create=False).load_stage(stage)
    assert sorted(pa) == sorted(ra)
    for name in ra:
        assert pa[name].dtype == ra[name].dtype, name
        assert pa[name].shape == ra[name].shape, name
        assert np.array_equal(pa[name], ra[name]), name


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_assembly_files_byte_equal(run_of, case):
    """Assembly.fasta, Assembly.gfa and Assembly-BothStrands.gfa are
    byte-equal to the JAX package's, and the whole mode-0 file family
    is written."""
    ref_dir, _ref, port_dir, _port = run_of(case)
    for name in OUTPUTS:
        with open(os.path.join(ref_dir, name), "rb") as f:
            ref = f.read()
        with open(os.path.join(port_dir, name), "rb") as f:
            assert f.read() == ref, name
    for name in MODE0_FILE_FAMILY:
        assert os.path.exists(os.path.join(port_dir, name)), name


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_summary_counts_equal_reference(run_of, case):
    """Every count of AssemblySummary.json equals the JAX package's."""
    _ref_dir, ref, _port_dir, port = run_of(case)
    for key in GOLDEN_KEYS + ["markerGraphMinCoverageUsed", "isolatedReadCount"]:
        assert port[key] == ref[key], key
    assert list(port["stageSeconds"]) == list(ref["stageSeconds"])


def test_golden_hashes_and_metrics_pinned(run_of):
    """On small_config the port's eight manifests hash to the pinned
    values and its GOLDEN_KEYS equal mode0_metrics.json."""
    _ref_dir, _ref, port_dir, _port = run_of("golden")
    with open(GOLDEN) as f:
        pinned = json.load(f)
    hashes = stage_hashes(port_dir)
    assert {s: hashes[s] for s in STAGES} == {s: pinned[s] for s in STAGES}
    with open(METRICS) as f:
        metrics = json.load(f)
    with open(os.path.join(port_dir, "AssemblySummary.json")) as f:
        summary = json.load(f)
    assert {k: summary[k] for k in GOLDEN_KEYS} == metrics


def test_main_path_options_run(run_of):
    """Under Nanopore-May2022 the run takes the main path's options: the
    automatic minCoverage, cross-edge removal and detangle run, and the
    JAX package's run assembles at least one segment."""
    _ref_dir, ref, _port_dir, port = run_of("main_path")
    assert ref["assembledSegmentCount"] >= 1
    assert "detangle" in ref["stageSeconds"]
    assert "removeLowCoverageCrossEdges" in ref["stageSeconds"]
    assert ref["markerGraphMinCoverageUsed"] == port["markerGraphMinCoverageUsed"] == 3
    assert port["alignmentCount"] == ref["alignmentCount"] == 1909
