"""shasta_tpu_torch and chip_smoke.py never import jax or shasta_tpu."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "shasta_tpu_torch")

_CHILD = r"""
import importlib, os, pkgutil, sys, tempfile
import shasta_tpu_torch
for m in pkgutil.walk_packages(shasta_tpu_torch.__path__, "shasta_tpu_torch."):
    importlib.import_module(m.name)
from shasta_tpu_torch.pipeline.assemble import Assembler
from shasta_tpu_torch.pipeline.config import AssemblyConfig
from shasta_tpu_torch.utils import synth
cfg = AssemblyConfig()
# tests/test_assembly_e2e.py:small_config on the golden input
cfg.reads.min_read_length = 500
cfg.kmers.k = 8
cfg.kmers.probability = 0.1
cfg.min_hash.hash_fraction = 0.05
cfg.min_hash.min_hash_iteration_count = 6
cfg.min_hash.max_bucket_size = 60
cfg.align.min_aligned_marker_count = 20
cfg.align.max_skip = 60
cfg.align.max_drift = 60
cfg.align.max_trim = 60
d = tempfile.mkdtemp(dir=sys.argv[1])
g = synth.random_genome(25000, seed=4242)
fa = os.path.join(d, "reads.fasta")
synth.write_fasta(fa, synth.sample_reads(g, 130, 3000, seed=4243, both_strands=True))
a = Assembler(os.path.join(d, "run"), cfg, device="cpu")
a.add_reads([fa]); a.select_kmers(); a.find_markers()
a.flag_palindromic_reads(); a.find_alignment_candidates(); a.compute_alignments()
assert a.alignments.count == 1992, a.alignments.count
bad = sorted(
    k for k in sys.modules
    if k in ("jax", "shasta_tpu") or k.startswith(("jax.", "jaxlib", "shasta_tpu."))
)
print("LEAKED", bad)
"""


def test_package_runs_without_jax_or_reference(tmp_path):
    """A fresh interpreter imports every module of the port and runs the
    six stages on the golden input on the CPU; neither jax nor
    shasta_tpu is loaded."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LEAKED []"


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|shasta_tpu)(?:\.|\s|$)", re.M
)


def test_sources_import_neither_jax_nor_reference():
    """No `import jax` and no import of shasta_tpu in the port's sources
    or in chip_smoke.py (shasta_tpu_torch itself does not match)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not _IMPORT.search(src), path
        assert "importlib.import_module(\"jax" not in src, path
