"""The port's kernel-reaching drivers and the mode-0 stage drivers that no
JAX test runs, against the JAX package's scripts on the mode-0 golden
input (tests/golden/mode0_stage_hashes.json's: a 25 kb genome, seed 4242,
130 reads of 3 kb, seed 4243, under small_config), each side on its own
copy of one run directory: after each step the exit code, the output
(but for the run directory's path), every stage hash and every file
written are equal. The port's scripts run with --device cpu.

ComputeAlignments.py, FindAlignmentCandidatesLowHash0.py and
FlagPalindromicReads.py reproduce the pinned hashes (the golden run's
Reads[Palindromic...] settings are FlagPalindromicReads.py's defaults),
and Mode0Assembly.py rewrites the whole run's Assembly.fasta and
Assembly.gfa byte for byte."""

import json
import os

import pytest

from tests.torch_common import (  # noqa: F401
    assert_same_step, one_torch_thread, port_script, run_jax_steps, run_steps,
    sampled_reads, script_state, small_run, twin_runs,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mode0_stage_hashes.json")


def steps_for(pair, name):
    """(script, arguments after the run directory, expected output, exit
    code, golden stages). ``pair``: the first stored alignment's reads as
    readId0 strand0 readId1 strand1; ``name``: read 3's name."""
    return [
        ("ComputeAlignments.py", [], "Computed 1992 alignments", 0, ["Alignments"]),
        ("FlagPalindromicReads.py", [], "Flagged 0 palindromic reads", 0, ["Reads"]),
        ("FindAlignmentCandidatesLowHash0.py", [], "2200 alignment candidates", 0,
         ["AlignmentCandidates"]),
        ("AlignOrientedReads.py", pair, "aligned markers", 0, []),
        ("AlignOrientedReads4.py", pair, "aligned markers", 0, []),
        ("Mode0Assembly.py", [], "Assembled 1 segments, N50 22399", 0, []),
        ("AnalyzeReadGraph.py", [], "Wrote", 0, []),
        ("CheckMarkerGraphIsStrandSymmetric.py", [], "strand symmetric", 0, []),
        ("CheckMarkerGraphVertices.py", [], "consistent", 0, []),
        ("ComputeAssemblyStatistics.py", [], "{", 0, []),
        ("ComputeMarkerGraphCoverageHistogram.py", [], "VertexCoverage,Frequency", 0, []),
        ("ComputeReadGraphConnectedComponents.py", [], "components", 0, []),
        ("GetReadId.py", [name], "3", 0, []),
        ("GetReadId.py", ["no-such-read"], "", 1, []),
        ("HistogramReadLength.py", [], "LengthKb,Frequency", 0, []),
        ("WriteAlignmentCandidates.py", [], "ReadId0,ReadId1,SameStrand,Frequency", 0, []),
        ("WriteFasta.py", [], "Wrote", 0, []),
        ("WriteGfa.py", [], "Wrote", 0, []),
        ("WriteMarkers.py", ["0", "1"], "Ordinal,KmerId,Position", 0, []),
        ("WriteRead.py", ["3"], ">", 0, []),
        ("WriteReadGraphEdges.py", [], "EdgeId,OrientedReadId0", 0, []),
        # Stage-rewriting drivers.
        ("CreateReadGraph.py", [], "Read graph", 0, ["ReadGraph"]),
        ("CreateReadGraph2.py", [], "adaptive criteria", 0, []),
        ("FlagChimericReads.py", [], "chimeric reads", 0, []),
        ("FlagCrossStrandReadGraphEdges.py", [], "cross-strand", 0, []),
        ("FlagInconsistentAlignments.py", [], "inconsistent", 0, []),
        ("RemoveReadGraphBridges.py", [], "bridge alignments", 0, []),
        ("CleanupDuplicateMarkers.py", [], "Cleanup stats", 0, []),
        ("StepSequence1.py", [], "=== Assemble", 0, []),
        ("TransitiveReduction.py", [], "alive after transitive reduction", 0, []),
        ("PruneMarkerGraphStrongSubgraph.py", [], "Pruned", 0, []),
        ("SimplifyMarkerGraph.py", [], "Simplified marker graph", 0, []),
        ("Detangle2.py", [], "Detangled (method 2)", 0, []),
        ("FindAlignmentCandidatesLowHash1.py", [], "with feature ordinals", 0, []),
    ]


def first_alignment(run_dir):
    from shasta_tpu_torch.data.store import RunStore

    al = RunStore(run_dir, create=False).load_stage("Alignments")
    r0, r1 = int(al["read_id0"][0]), int(al["read_id1"][0])
    return [str(r0), "0", str(r1), "0" if al["same_strand"][0] else "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from shasta_tpu_torch.data.reads import ReadStore
    from shasta_tpu_torch.data.store import RunStore

    root = str(tmp_path_factory.mktemp("golden"))
    base = small_run(root, sampled_reads(25000, 130, 3000, (4242, 4243)))
    name = ReadStore.from_arrays(RunStore(base, create=False).load_stage("Reads")).names[3]
    steps = steps_for(first_alignment(base), name)
    jax_root, port_root = twin_runs(base, root)
    spec = [{"script": s, "argv": ["{root}/run"] + extra} for s, extra, *_ in steps]
    spec.append({"script": "Test.py", "argv": []})
    ref = run_jax_steps(spec, jax_root)
    for step in spec:
        step["argv"] = step["argv"] + ["--device", "cpu"]
    got = run_steps(spec, port_root, port_script)
    return steps, ref, got, jax_root, port_root, base


STEP_IDS = [f"{s[0]}-{i}" for i, s in enumerate(steps_for(["0"] * 4, "r"))]


@pytest.mark.parametrize("i", range(len(STEP_IDS)), ids=STEP_IDS)
def test_golden_script_matches_reference(runs, i):
    steps, ref, got, jax_root, port_root, _ = runs
    _, _, expect, rc, golden = steps[i]
    assert_same_step(ref[i], got[i], jax_root, port_root, expect=expect, rc=rc)
    with open(GOLDEN) as f:
        pinned = json.load(f)
    stages = got[i]["state"]["stages"]["run"]
    assert {s: stages[s] for s in golden} == {s: pinned[s] for s in golden}


def test_self_test_matches_reference(runs):
    _, ref, got, jax_root, port_root, _ = runs
    assert_same_step(ref[-1], got[-1], jax_root, port_root, expect="Self-test passed.")


def test_mode0_rerun_rewrites_the_whole_runs_files(runs):
    """Mode0Assembly.py on the stored run writes the whole run's
    Assembly.fasta and Assembly.gfa again, byte for byte."""
    steps, ref, got, _, _, base = runs
    i = [s[0] for s in steps].index("Mode0Assembly.py")
    whole = script_state(os.path.dirname(base))["files"]
    for side in (ref[i], got[i]):
        for name in ("run/Assembly.fasta", "run/Assembly.gfa"):
            assert side["state"]["files"][name] == whole[name], name
