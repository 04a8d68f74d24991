"""shasta_tpu_torch and chip_smoke.py never import jax or shasta_tpu."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "shasta_tpu_torch")

_CHILD = r"""
import contextlib, importlib, io, json, os, pkgutil, sys, tempfile
import shasta_tpu_torch
for m in pkgutil.walk_packages(shasta_tpu_torch.__path__, "shasta_tpu_torch."):
    importlib.import_module(m.name)
from shasta_tpu_torch.__main__ import main
from shasta_tpu_torch.utils import synth
d = tempfile.mkdtemp(dir=sys.argv[1])
g = synth.random_genome(25000, seed=4242)
fa = os.path.join(d, "reads.fasta")
synth.write_fasta(fa, synth.sample_reads(g, 130, 3000, seed=4243, both_strands=True))
conf = os.path.join(d, "empty.conf")
open(conf, "w").close()
# tests/test_assembly_e2e.py:small_config on the golden input
small = [
    "--Reads.minReadLength", "500", "--Kmers.k", "8",
    "--Kmers.probability", "0.1", "--MinHash.hashFraction", "0.05",
    "--MinHash.minHashIterationCount", "6", "--MinHash.maxBucketSize", "60",
    "--Align.minAlignedMarkerCount", "20", "--Align.maxSkip", "60",
    "--Align.maxDrift", "60", "--Align.maxTrim", "60",
    "--ReadGraph.maxAlignmentCount", "8", "--MarkerGraph.minCoverage", "3",
]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = main(["--command", "assemble", "--config", conf, "--input", fa,
               "--assemblyDirectory", os.path.join(d, "run"),
               "--device", "cpu"] + small)
assert rc == 0, rc
summary = json.loads(out.getvalue())
assert summary["alignmentCount"] == 1992, summary["alignmentCount"]
assert summary["assembledSegmentCount"] == 1, summary["assembledSegmentCount"]
# The explorer's pages over the run, its on-demand alignment included.
from shasta_tpu_torch.http.explore import Explorer, _routes
routes = _routes(Explorer(os.path.join(d, "run"), device="cpu"))
assert "shasta_tpu assembly" in routes["/"]({})
routes["/alignment"]({"readId0": ["0"], "readId1": ["1"]})
# The run's LowHash again on a one-rank mesh (a gloo world on the CPU).
from shasta_tpu_torch.data.markers import MarkerStore
from shasta_tpu_torch.data.store import RunStore
from shasta_tpu_torch.ops.lowhash import LowHashParams
from shasta_tpu_torch.parallel.mesh import make_mesh, sharded_find_candidates
markers = MarkerStore.from_arrays(RunStore(os.path.join(d, "run"), create=False).load_stage("Markers"))
pairs = sharded_find_candidates(make_mesh(1, device="cpu"), markers,
                                LowHashParams(m=4, hash_fraction=0.05, iteration_count=6, max_bucket_size=60))
assert pairs.count == 2200, pairs.count
# Mode-2, mode-3 and alignment-method-4 runs of the same input.
for extra in (["--Assembly.mode", "2"], ["--Assembly.mode", "3"],
              ["--Align.alignMethod", "4"]):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--command", "assemble", "--config", conf, "--input", fa,
                   "--assemblyDirectory", os.path.join(d, extra[1]),
                   "--device", "cpu"] + small + extra)
    assert rc == 0, (extra, rc)
    summary = json.loads(out.getvalue())
    assert summary["alignmentCount"] > 0, extra
    if extra[1] == "2":
        assert "assemblyGraph2" in summary["stageSeconds"]
    if extra[1] == "3":
        assert "createJaccardGraph" in summary["stageSeconds"]
        assert summary["mode3SegmentCount"] >= 1
# A stage driver (shasta_tpu_torch/scripts) in this process on the run.
sys.path.insert(0, os.path.join(os.path.dirname(shasta_tpu_torch.__file__), "scripts"))
import _common
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = _common.load("ComputeAlignments").main([os.path.join(d, "run"), "--device", "cpu"])
assert rc == 0 and out.getvalue() == "Computed 1992 alignments.\n", (rc, out.getvalue())
# The bench entry point is among the modules imported above; it imports
# neither the repository root's bench.py nor the tests.
assert "shasta_tpu_torch.bench" in sys.modules
bad = sorted(
    k for k in sys.modules
    if k in ("jax", "shasta_tpu", "bench", "tests")
    or k.startswith(("jax.", "jaxlib", "shasta_tpu.", "tests."))
)
print("LEAKED", bad)
"""


def test_package_runs_without_jax_or_reference(tmp_path):
    """A fresh interpreter imports every module of the port, the CLI
    included, and runs the whole assemble command on the golden input
    on the CPU, under modes 0, 2 and 3 and alignment method 4, renders the
    explorer's pages over the mode-0 run, runs its LowHash again on a
    one-rank mesh and its computeAlignments again through the driver
    ComputeAlignments.py --device cpu; neither jax nor shasta_tpu is
    loaded."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LEAKED []"


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|shasta_tpu|tests|bench)(?:\.|\s|$)", re.M
)


def test_sources_import_neither_jax_nor_reference():
    """No `import jax`, no import of shasta_tpu, of the tests or of the
    repository root's bench.py in the port's sources, its stage drivers
    (shasta_tpu_torch/scripts) and its bench included, or in chip_smoke.py
    (shasta_tpu_torch itself does not match)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    assert os.path.join(PKG, "scripts", "ComputeAlignments.py") in files
    assert os.path.join(PKG, "bench.py") in files
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not _IMPORT.search(src), path
        assert "importlib.import_module(\"jax" not in src, path
