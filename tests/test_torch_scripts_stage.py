"""The port's stage drivers (shasta_tpu_torch/scripts) against the JAX
package's (scripts/), in tests/test_scripts.py:test_stage_scripts_rerun's
order on its input (seeds 201 and 202 under small_config), each side on
its own copy of one run directory: after each step the exit code, the
output (but for the run directory's path), every stage hash and every
file written are equal. The port's scripts run with --device cpu."""

import pytest

from tests.torch_common import (  # noqa: F401
    assert_same_step, one_torch_thread, port_script, run_jax_steps, run_steps,
    sampled_reads, small_run, twin_runs,
)

# (script, arguments after the run directory, expected output); "{root}"
# is each side's own directory. None: GenerateFeedback's flags.
STEPS = [
    ("CreateMarkerGraphVertices.py", [], "vertices"),
    ("CreateMarkerGraphEdges.py", [], "edges"),
    ("Mode0Assembly.py", [], "Assembled"),
    ("FindMarkers.py", [], "markers"),
    ("WriteAssemblyGraph.py", ["{root}/ag.csv"], "assembly graph edges"),
    ("WriteAlignmentDetails.py", ["{root}/ad.csv"], "alignments"),
    ("WriteMarkersFrequency.py", ["{root}/mf.csv"], "frequencies"),
    ("GetConfig.py", [], "[Kmers]"),
    ("WriteReads.py", ["{root}/reads.fasta"], "reads"),
    ("WriteOrientedRead.py", ["0", "1"], ">"),
    ("WriteGfaBothStrands.py", [], "Wrote"),
    ("AssembleMarkerGraphVertices.py", [], "repeat counts"),
    ("CreateAssemblyGraphEdges.py", [], "edges"),
    ("Detangle.py", [], "Detangled"),
    ("RandomlySelectKmers.py", [], "marker k-mers"),
    ("SelectKmersBasedOnFrequency.py", [], "marker k-mers"),
    ("SelectKmers2.py", [], "marker k-mers"),
    ("SelectKmers4.py", [], "marker k-mers"),
    ("GenerateFeedback.py", None, "Assembled segments N50"),
    ("AnalyzeAlignmentMatrix.py", ["0", "0", "1", "0"], "Matrix dots"),
    ("AlignOrientedReads1.py", ["0", "0", "1", "0"], "aligned markers"),
    ("FindMarkerGraphReverseComplementVertices.py", [], "rc map verified"),
    ("FindMarkerGraphReverseComplementEdges.py", [], "rc edge map verified"),
    ("ComputeSortedMarkers.py", [], "Sorted markers stored"),
    ("WriteBadMarkerGraphVertices.py", [], "duplicate oriented reads"),
    ("ComputeMarkerGraphVerticesCoverageData.py", [], "Wrote"),
    ("VertexCoverageStatisticsByKmerId.py", [], "Wrote"),
    ("WriteParallelMarkerGraphEdges.py", [], "parallel edges"),
    ("ReadGraphClustering.py", [], "clusters"),
    ("CreateCompressedAssemblyGraph.py", [], "Compressed assembly graph"),
    ("WriteOrientedReadsBySegment.py", [], "Wrote"),
    ("FindAssemblyGraphBubbles.py", [], "bubbles"),
    ("ColorGfaKeySegments.py", [], "key segments"),
    ("AssembleSegment.py", ["0"], "Segment 0"),
    ("ClusterMarkerGraphEdgeOrientedReads.py", ["0"], "clusters"),
    ("AssembleMarkerGraphEdges.py", [], "Assembled consensus"),
    ("ReverseTransitiveReduction.py", [], "Reverse transitive reduction"),
    ("CreateMarkerGraphSecondaryEdges.py", [], "secondary marker graph"),
    ("SplitMarkerGraphSecondaryEdges.py", [], "secondary edges"),
    ("SetMarkerGraphEdgeFlags.py", ["--wasPruned", "0"], "Set"),
    ("CreateAndCleanupMarkerGraph.py", [], "Marker graph"),
    ("CreateMarkerGraphAndTransitiveReduction.py", [], "alive after"),
    ("CreateAssemblyGraphVertices.py", [], "Assembly graph"),
    ("Assemble.py", [], "segments"),
    ("CreateAssembly.py", [], "assembledSegmentCount"),
]


def argv(extra):
    if extra is None:
        return ["--assemblyDirectory", "{root}/run", "--genomeSizeMbp", "0.015"]
    return ["{root}/run"] + extra


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stage"))
    jax_root, port_root = twin_runs(small_run(root, sampled_reads(15000, 90, 3000, (201, 202))), root)
    steps = [{"script": s, "argv": argv(extra)} for s, extra, _ in STEPS]
    ref = run_jax_steps(steps, jax_root)
    for step, (_, extra, _) in zip(steps, STEPS):
        if extra is not None:
            step["argv"] = step["argv"] + ["--device", "cpu"]
    got = run_steps(steps, port_root, port_script)
    return ref, got, jax_root, port_root


@pytest.mark.parametrize("i", range(len(STEPS)), ids=[s for s, _, _ in STEPS])
def test_stage_script_matches_reference(runs, i):
    ref, got, jax_root, port_root = runs
    assert_same_step(ref[i], got[i], jax_root, port_root, expect=STEPS[i][2])
