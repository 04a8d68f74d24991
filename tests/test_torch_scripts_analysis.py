"""The port's argparse-style, mode-3 and iterative-assembly drivers
against the JAX package's, in tests/test_scripts.py:test_analysis_scripts'
order on its input (seeds 211 and 212 under small_config), each side on
its own copy of one run directory: after each step the exit code, the
output (but for the run directory's path), every stage hash and every
file written are equal. The port's scripts run with --device cpu."""

import pytest

from tests.torch_common import (  # noqa: F401
    assert_same_step, one_torch_thread, port_script, run_jax_steps, run_steps,
    sampled_reads, small_run, twin_runs,
)

# (script, arguments after the run directory, expected output).
STEPS = [
    ("WriteOrientedReadPath.py", ["--readId", "0", "--strand", "0"], "Ordinal,VertexId"),
    ("WritePseudoPath.py", ["--readId", "0", "--strand", "0"], "Pseudo-path"),
    ("AlignPseudoPaths.py", ["0", "0", "1", "0"], "alignment score"),
    ("WriteLocalReadGraphReads.py",
     ["--readId", "0", "--strand", "0", "--maxDistance", "2"], "oriented reads"),
    ("WriteLocalAlignmentCandidateReads.py",
     ["--readId", "0", "--strand", "0", "--maxDistance", "2"], "oriented reads"),
    ("ColorGfaWithTwoReads.py",
     ["--readId0", "0", "--strand0", "0", "--readId1", "1", "--strand1", "0"], "Wrote"),
    ("ColorGfaBySimilarityToSegment.py", ["--segmentId", "0"], "Wrote"),
    ("AnalyzeAssemblyGraphBubbles.py", [], "bubble pairs"),
    ("CreateReadGraphMode1.py", [], "Mode-1 read graph"),
    ("Mode3Assembly.py", [], None),
    ("CreateMode3PathGraph.py", [], "Jaccard graph"),
    ("AnalyzeMode3Subgraph.py", ["0", "1"], "SegmentA"),
    ("CreateReadGraphUsingPseudoPaths.py", [], "Read graph rebuilt"),
    ("Mode2Assembly-B-Prepare.py", [], "page cache"),
]
# Mode2Assembly-B-Prepare.py opens no run and takes no --device.
NO_DEVICE = {"Mode2Assembly-B-Prepare.py"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("analysis"))
    jax_root, port_root = twin_runs(small_run(root, sampled_reads(15000, 90, 3000, (211, 212))), root)
    steps = [{"script": s, "argv": ["{root}/run"] + extra} for s, extra, _ in STEPS]
    ref = run_jax_steps(steps, jax_root)
    for step in steps:
        if step["script"] not in NO_DEVICE:
            step["argv"] = step["argv"] + ["--device", "cpu"]
    got = run_steps(steps, port_root, port_script)
    return ref, got, jax_root, port_root


@pytest.mark.parametrize("i", range(len(STEPS)), ids=[s for s, _, _ in STEPS])
def test_analysis_script_matches_reference(runs, i):
    ref, got, jax_root, port_root = runs
    assert_same_step(ref[i], got[i], jax_root, port_root, expect=STEPS[i][2])
