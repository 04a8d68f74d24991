"""The port's drivers that open no stored run, against the JAX package's:
tests/test_scripts.py:test_standalone_scripts' utilities on its inputs,
and the other standalone drivers (FASTQ conversion, the configuration
table, the native library, the Bayesian model, several assemblies and
their summary, saving, cleaning up and restoring a run's Data/), each
side in its own copy of one directory of inputs: after each step the exit
code, the output (but for the directory's path), every stage hash and
every file written are equal. The drivers that run the DP run with
--device cpu.

Also: a driver run without --device on a machine with no card exits
non-zero and names the missing card, and generateBandageLabelsFromAlignment.py
colors a reference name alike in every run (fault 7 of ROADMAP.md's
queue 3: the JAX script's colors follow PYTHONHASHSEED)."""

import gzip
import os
import shutil
import subprocess
import sys

import pytest
import torch

from tests.torch_common import (  # noqa: F401
    JAX_SCRIPTS, PORT_SCRIPTS, ROOT, SMALL_CONF, assert_same_step, one_torch_thread,
    port_script, repaired_script, run_jax_steps, run_steps, sampled_reads,
)

# (script, arguments, expected output, exit code, runs the DP); "{root}"
# is each side's own directory.
STEPS = [
    ("dset64Test.py", ["2000", "4000", "17"], "PASSED", 0, False),
    ("GenerateConfig.py", ["--genomeSizeMbp", "0.4", "--out", "{root}/gen.conf"],
     "Configuration written", 0, False),
    ("SetupRunDirectory.py", ["{root}/rundir"], "ready", 0, False),
    ("SetupRunDirectory.py", ["{root}/rundir-ont", "--config", "Nanopore-May2022"],
     "ready", 0, False),
    ("FastqGzToFasta.py", ["{root}/x.fastq.gz", "{root}/x.fasta"], "Converted 2 reads", 0, False),
    ("FastqToFasta.py", ["{root}/x.fastq.gz", "{root}/y.fasta"], "Converted 2 reads", 0, False),
    ("FastqToFastaAll.py", ["{root}/fq"], "(2 reads)", 0, False),
    ("comparePhaseAssignments.py", ["{root}/a.csv", "{root}/b.csv"], "3/3 (100.0%)", 0, False),
    ("comparePhaseAssignments.py", ["{root}/a.csv"], "Usage", 2, False),
    ("CreateConfigurationTable.py", ["{root}/confgen"], "verified", 0, False),
    ("CheckConfigurations.py", [], "Nanopore-May2022: ok", 0, False),
    ("SetupSmallRunDirectory.py", ["{root}/smallrun", "{root}/x.fasta"], "ready", 0, False),
    ("Copy.py", ["{root}/a.csv", "{root}/rundir"], "Copied", 0, False),
    ("Copy.py", [], "Usage", 1, False),
    ("CopyDirectory.py", ["{root}/fq", "{root}/rundir2"], "Copied 4 files", 0, False),
    ("CreateLocalSubgraph.py", ["{root}/g.dot", "a", "1"], "2 vertices", 0, False),
    ("SimpleBayesianConsensusCallerCreateBuiltin.py", ["{root}/model.csv", "test-model"],
     "verified model", 0, False),
    ("TestSimpleBayesianConsensusCaller.py", ["{root}/model.csv"], "Model:", 0, False),
    ("TestSimpleBayesianConsensusCaller.py", [], "Model:", 0, False),
    ("CreateModules.py", [], "Native library built and loaded", 0, False),
    ("RunAssemblies.py",
     ["--input", "{root}/small.fasta", "--config", "{root}/small.conf", "--outDir", "{root}/ra"],
     "small", 0, True),
    ("SummarizeAssemblies.py", ["{root}/ra/small", "{root}/nowhere"], "RunDirectory,", 0, False),
    ("SaveRun.py", ["{root}/ra/small"], "Saved", 0, False),
    ("CleanupRunDirectory.py", ["{root}/ra/small"], "Removed", 0, False),
    ("CleanupRunDirectory.py", ["{root}/ra/small"], "No Data directory", 1, False),
    ("RestoreRun.py", ["{root}/ra/small"], "Restored", 0, False),
    ("GetConfig.py", ["{root}/ra/small"], "[Kmers]", 0, False),
    # A built-in configuration (k 10, whose k-mer tables are small) on a
    # read shorter than its minReadLength: an empty assembly.
    ("RunAssemblies.py",
     ["--input", "{root}/x.fasta", "--config", "Nanopore-Dec2019", "--outDir", "{root}/ra"],
     "Nanopore-Dec2019", 0, True),
]
# Faults of the JAX scripts (ROADMAP.md, queue 3): by step, the text the
# port repairs, its repair, and what the JAX script as it stands raises.
# The JAX side runs the script as it stands (it raises before it writes
# anything), then the script repaired.
FAULTS = {
    3: ("        config = get_configuration(args.config)\n",
        "        config = AssemblyConfig.from_conf_text(get_configuration(args.config))\n",
        "AttributeError: 'str' object has no attribute 'write_conf'"),
    len(STEPS) - 1: (
        "            config = get_configuration(name)\n",
        "            config = AssemblyConfig.from_conf_text(get_configuration(name))\n",
        "AttributeError: 'str' object has no attribute 'reads'"),
}
MODEL_DIR = {"jax": "SHASTA_TPU_BAYESIAN_MODEL_DIR", "port": "SHASTA_TORCH_BAYESIAN_MODEL_DIR"}


def write_inputs(d):
    """tests/test_scripts.py:test_standalone_scripts' inputs, a directory
    of two FASTQ files, a Bayesian model and a small assembly's reads (60
    reads of 3 kb from a 12 kb genome, seeds 77 and 78) with small_config
    as a conf file."""
    os.makedirs(os.path.join(d, "fq"))
    fastq = "@r0\nACGTACGT\n+\nIIIIIIII\n@r1\nTTTTACGT\n+\nIIIIIIII\n"
    with gzip.open(os.path.join(d, "x.fastq.gz"), "wt") as f:
        f.write(fastq)
    with gzip.open(os.path.join(d, "fq", "p.fastq.gz"), "wt") as f:
        f.write(fastq)
    with open(os.path.join(d, "fq", "q.fastq"), "w") as f:
        f.write(fastq.replace("@r", "@q"))
    with open(os.path.join(d, "a.csv"), "w") as f:
        f.write("Segment,Length,Haplotype,PhasedComponent\n1,100,0,0\n2,120,1,0\n3,90,0,1\n")
    with open(os.path.join(d, "b.csv"), "w") as f:
        f.write("Segment,Length,Haplotype,PhasedComponent\n1,100,1,0\n2,120,0,0\n3,90,0,1\n")
    with open(os.path.join(d, "g.dot"), "w") as f:
        f.write('digraph G {\n"a" -> "b"\n"b" -> "c"\n"c" -> "d"\n}\n')
    shutil.copy(
        os.path.join(ROOT, "shasta_tpu_torch", "consensus", "models", "guppy-2.3.1-a.csv"),
        os.path.join(d, "model.csv"),
    )
    sampled_reads(12000, 60, 3000, (77, 78))(os.path.join(d, "small.fasta"))
    sections = {}
    for section, key, value in SMALL_CONF:
        sections.setdefault(section, []).append(f"{key} = {value}")
    with open(os.path.join(d, "small.conf"), "w") as f:
        f.write("".join(f"[{s}]\n" + "\n".join(kv) + "\n\n" for s, kv in sections.items()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("standalone"))
    write_inputs(os.path.join(root, "base"))
    roots = {}
    for side in ("jax", "port"):
        roots[side] = os.path.join(root, side)
        shutil.copytree(os.path.join(root, "base"), roots[side])
        os.makedirs(os.path.join(roots[side], "models"))
    steps = {
        side: [
            {"script": s, "argv": list(a) + (["--device", "cpu"] if dp and side == "port" else []),
             "env": {MODEL_DIR[side]: "{root}/models"}}
            for s, a, _, _, dp in STEPS
        ]
        for side in roots
    }
    jax_steps = []
    for i, step in enumerate(steps["jax"]):
        if i in FAULTS:
            old, new, _ = FAULTS[i]
            jax_steps.append(step)
            step = dict(step, script=repaired_script(step["script"], old, new, root))
        jax_steps.append(step)
    ref = run_jax_steps(jax_steps, roots["jax"])
    as_is = {}
    for i in sorted(FAULTS):
        as_is[i] = ref.pop(i)
    got = run_steps(steps["port"], roots["port"], port_script)
    return ref, got, roots["jax"], roots["port"], as_is


@pytest.mark.parametrize(
    "i", range(len(STEPS)), ids=[f"{s[0]}-{i}" for i, s in enumerate(STEPS)]
)
def test_standalone_script_matches_reference(runs, i):
    ref, got, jax_root, port_root, _ = runs
    _, _, expect, rc, _ = STEPS[i]
    assert_same_step(ref[i], got[i], jax_root, port_root, expect=expect, rc=rc)


@pytest.mark.parametrize("i", sorted(FAULTS), ids=[STEPS[i][0] for i in sorted(FAULTS)])
def test_reference_script_takes_a_configuration_name_for_its_object(runs, i):
    """scripts/SetupRunDirectory.py:30 and scripts/RunAssemblies.py:37 use
    get_configuration(name), the built-in configuration's conf text, as
    an AssemblyConfig, and raise; the port's scripts parse the text."""
    _, got, _, _, as_is = runs
    assert as_is[i]["rc"] == FAULTS[i][2]
    assert got[i]["rc"] == STEPS[i][3]


def bandage(scripts, tmp_path, hash_seed):
    """generateBandageLabelsFromAlignment.py of ``scripts`` on a PAF of
    eight segments on eight references, under PYTHONHASHSEED=hash_seed:
    its output, and its two files' text."""
    paf = tmp_path / "aln.paf"
    paf.write_text("".join(
        f"{i}\t100\t0\t100\t+\tchr{i}\t1000\t{10 * i}\t{10 * i + 100}\t95\t100\t60\n"
        for i in range(8)
    ))
    prefix = tmp_path / f"bandage-{os.path.basename(os.path.dirname(scripts))}-{hash_seed}"
    r = subprocess.run(
        [sys.executable, os.path.join(scripts, "generateBandageLabelsFromAlignment.py"),
         str(paf), str(prefix)],
        capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONHASHSEED=str(hash_seed)),
    )
    assert r.returncode == 0, r.stderr
    labels = (tmp_path / f"{prefix.name}-labels.csv").read_text()
    colors = (tmp_path / f"{prefix.name}-colors.csv").read_text()
    return r.stdout.replace(str(prefix), "<prefix>"), labels, colors


def test_bandage_colors_do_not_follow_the_hash_seed(tmp_path):
    """The labels and the output equal the JAX script's; the JAX script's
    colors change with PYTHONHASHSEED (str.__hash__), the port's do not."""
    ref = [bandage(JAX_SCRIPTS, tmp_path, seed) for seed in (1, 2)]
    got = [bandage(PORT_SCRIPTS, tmp_path, seed) for seed in (1, 2)]
    assert "8 segments labeled" in got[0][0]
    assert [g[:2] for g in got] == [r[:2] for r in ref]
    assert "0,chr0:0" in got[0][1]
    assert ref[0][2] != ref[1][2]
    assert got[0][2] == got[1][2]


@pytest.mark.parametrize("script, argv", [
    ("ComputeAlignments.py", ["{run}"]),
    ("WriteOrientedReadPath.py", ["{run}", "--readId", "0", "--strand", "0"]),
    ("Test.py", []),
    ("RunAssemblies.py", ["--input", "{root}/small.fasta", "--config", "{root}/small.conf",
                          "--outDir", "{root}/ra"]),
])
def test_without_device_needs_a_card(runs, script, argv):
    """Without --device a driver runs the DP on the card: with no card it
    exits non-zero and says so, before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    port_root = runs[3]
    root = os.path.join(port_root, "..", "nocard-" + script)
    shutil.copytree(os.path.join(port_root, "..", "base"), root)
    argv = [a.replace("{root}", root).replace("{run}", os.path.join(port_root, "ra", "small"))
            for a in argv]
    r = subprocess.run(
        [sys.executable, os.path.join(PORT_SCRIPTS, script)] + argv,
        capture_output=True, text=True, timeout=120, cwd=root,
    )
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
    assert not os.path.exists(os.path.join(root, "ra"))
