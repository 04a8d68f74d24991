"""The port's mode-2 drivers against the JAX package's, on the mode-2
golden input (tests/torch_common.py:write_mode2_reads) under
tests/test_reference_parity.py:_golden_run_mode2's configuration, each
side on its own copy of one run directory: after each step the exit
code, the output (but for the run directory's path), every stage hash and
every file written are equal. The port's scripts run with --device cpu.
CreateMarkerGraphEdgesStrict.py is held to the JAX script with its call
repaired (the script as it stands raises)."""

import pytest

from tests.torch_common import (  # noqa: F401
    assert_same_step, one_torch_thread, port_script, repaired_script, run_jax_steps,
    run_steps, small_run, twin_runs, write_mode2_reads,
)

MODE2 = {
    "Assembly.mode": 2, "MarkerGraph.minEdgeCoverage": 3,
    "MarkerGraph.minEdgeCoveragePerStrand": 0,
    "Assembly.mode2.bubbleRemoval.componentSizeThreshold": 3,
}

# (script, expected output); each runs on the run directory alone.
STEPS = [
    ("CreateMarkerGraphEdgesStrict.py", "strict edges"),
    ("Mode2Assembly-A.py", "Mode-2 marker graph"),
    ("Mode2Assembly-B.py", "{"),
    ("Mode2Assembly.py", "{"),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mode2"))
    jax_root, port_root = twin_runs(small_run(root, write_mode2_reads, **MODE2), root)
    steps = [{"script": s, "argv": ["{root}/run"]} for s, _ in STEPS]
    # The JAX script as it stands first (it raises before it writes
    # anything), then repaired in the JAX side's place.
    bad = "create_marker_graph_edges_strict(\n    a.markers, a.marker_graph,"
    repaired = dict(steps[0], script=repaired_script(
        STEPS[0][0], bad, bad.replace("a.markers", "a.reads, a.markers"), root
    ))
    ref = run_jax_steps([steps[0], repaired] + steps[1:], jax_root)
    for step in steps:
        step["argv"].extend(["--device", "cpu"])
    got = run_steps(steps, port_root, port_script)
    return ref[0], ref[1:], got, jax_root, port_root


def test_reference_strict_script_omits_the_reads(runs):
    """scripts/CreateMarkerGraphEdgesStrict.py:11 calls
    create_marker_graph_edges_strict(markers, mg, ...) without the reads
    (shasta_tpu/graph/mode2.py:47 takes reads, markers, mg) and raises;
    the port's script passes them."""
    as_is, _, got, _, _ = runs
    assert as_is["rc"] == (
        "TypeError: create_marker_graph_edges_strict() missing 1 required "
        "positional argument: 'mg'"
    )
    assert got[0]["rc"] == 0


@pytest.mark.parametrize("i", range(len(STEPS)), ids=[s for s, _ in STEPS])
def test_mode2_script_matches_reference(runs, i):
    _, ref, got, jax_root, port_root = runs
    assert_same_step(ref[i], got[i], jax_root, port_root, expect=STEPS[i][1])
