"""The port's scale and A/B modules (shasta_tpu_torch/benchmarks) against
the JAX system's scripts in benchmarks/, on the CPU.

Each JAX script runs as a script (runpy) with the JAX ``run_assembly``
swapped for a recorder that keeps the input FASTA's bytes and the
``AssemblyConfig`` and stops it (or, for the phase experiment, lets it go
on to its next configuration). Sizes are cut by one factor, ``CUT``, on
both sides: on the JAX side by wrapping ``tests.synth``'s size arguments,
on the port's by monkeypatching its modules' constants. Every comparison
is exact: FASTA bytes, ``dataclasses.asdict`` of the configurations,
stage hashes and chain outputs.
"""

import dataclasses
import json
import os
import runpy
import subprocess
import sys
import tempfile

import pytest
import torch

import shasta_tpu.pipeline.assemble as JA
import shasta_tpu.utils.accuracy as JAC
from shasta_tpu.data.store import RunStore as JaxRunStore
from shasta_tpu_torch import bench as PB
from shasta_tpu_torch.benchmarks import mode2_phase_exp as PX
from shasta_tpu_torch.benchmarks import mode2_scale_bench as M2
from shasta_tpu_torch.benchmarks import scale_bench as SB
from shasta_tpu_torch.benchmarks import waves_ab as WA
from tests import synth as TS
from tests.torch_common import one_torch_thread, stage_hashes  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Sizes over CUT: a 20 kb genome for scale_bench (SCALE 1), 25 reads of
# 10 kb a haplotype for mode 2's uniform1, 0.4x ONT coverage a haplotype.
CUT = 50
JAX_RUN_ASSEMBLY = JA.run_assembly


class _Stop(Exception):
    pass


def jax_script(name, monkeypatch, tmp_path, env=(), cut_genome=True, go_on=False, reads_cut=CUT):
    """benchmarks/<name>.py run as a script with ``env`` set, its sizes cut
    by CUT: ``sample_reads``' count (by ``reads_cut``), and ``random_genome``'s length (with
    ``cut_genome``) or else ``sample_reads_ont``'s coverage. Returns
    [(input FASTA bytes, asdict(config), config)] of its run_assembly
    calls. With ``go_on`` each call leaves an empty Assembly-Phased.fasta
    and the phasing grades are stubbed, so the script goes on."""
    calls = []

    def recorder(files, run_dir, config=None, *a, **kw):
        with open(files[0], "rb") as f:
            calls.append((f.read(), dataclasses.asdict(config), config))
        if not go_on:
            raise _Stop
        os.makedirs(run_dir)
        open(os.path.join(run_dir, "Assembly-Phased.fasta"), "w").close()
        return {}

    genome, reads, ont = TS.random_genome, TS.sample_reads, TS.sample_reads_ont
    monkeypatch.setattr(TS, "sample_reads",
                        lambda g, n, *a, **kw: reads(g, n // reads_cut, *a, **kw))
    if cut_genome:
        monkeypatch.setattr(TS, "random_genome", lambda n, seed=0: genome(n // CUT, seed))
    else:
        monkeypatch.setattr(TS, "sample_reads_ont", lambda g, cov, **kw: ont(g, cov / CUT, **kw))
    monkeypatch.setattr(JA, "run_assembly", recorder)
    if go_on:
        stub = {"meanPurity": 0, "hetKmerRecall": 0, "blockSwitches": 0, "isolatedFlips": 0,
                "informativeSites": 0}
        monkeypatch.setattr(JAC, "diploid_phasing_metrics", lambda *a, **kw: stub)
        monkeypatch.setattr(JAC, "phasing_switch_errors", lambda *a, **kw: stub)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(sys, "path", list(sys.path))
    for k, v in env:
        monkeypatch.setenv(k, v)
    try:
        runpy.run_path(os.path.join(ROOT, "benchmarks", name + ".py"), run_name="__main__")
    except _Stop:
        pass
    return calls


def fasta_bytes(tmp_path, reads):
    path = os.path.join(tmp_path, "port.fasta")
    from shasta_tpu_torch.utils import synth

    synth.write_fasta(path, reads)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("regime,iterative", [
    ("uniform1", False), ("ont", False), ("uniform1", True),
])
def test_scale_bench_inputs_equal_script(monkeypatch, tmp_path, regime, iterative):
    """scale_bench's reads (FASTA bytes) and configuration equal
    benchmarks/scale_bench.py's at SCALE 1 cut by CUT, for each regime and
    under ITERATIVE=1."""
    env = [("SCALE", "1"), ("REGIME", regime), ("ITERATIVE", "1" if iterative else "0")]
    (ref_fasta, ref_cfg, _), = jax_script("scale_bench", monkeypatch, tmp_path, env)
    monkeypatch.setattr(SB, "BASES_PER_MB", SB.BASES_PER_MB // CUT)
    scale, got_regime, got_iterative = SB.knobs()
    assert (scale, got_regime, got_iterative) == (1, regime, iterative)
    genome = SB.make_genome(scale)
    assert genome.shape[0] == 20_000
    assert fasta_bytes(tmp_path, SB.make_reads(genome, regime, scale)) == ref_fasta
    assert dataclasses.asdict(SB.make_config(regime, iterative)) == ref_cfg


@pytest.mark.parametrize("regime", ["uniform1", "ont"])
def test_mode2_scale_bench_inputs_equal_script(monkeypatch, tmp_path, regime):
    """mode2_scale_bench's reads and configuration equal
    benchmarks/mode2_scale_bench.py's at SCALE 1, the reads cut by CUT (the
    script's SNP positions follow its genome's full size, so the genome
    is not cut)."""
    env = [("SCALE", "1"), ("REGIME", regime)]
    (ref_fasta, ref_cfg, _), = jax_script(
        "mode2_scale_bench", monkeypatch, tmp_path, env, cut_genome=False)
    monkeypatch.setattr(M2, "UNIFORM_BASES_PER_READ", M2.UNIFORM_BASES_PER_READ * CUT)
    monkeypatch.setattr(M2, "ONT_COVERAGE", M2.ONT_COVERAGE / CUT)
    scale, got_regime = M2.knobs()
    hap_a, hap_b, snp = M2.make_haplotypes(M2.BASES_PER_MB * scale)
    assert snp.shape[0] == 1429 and int((hap_a != hap_b).sum()) == 1429
    assert fasta_bytes(tmp_path, M2.make_reads(hap_a, hap_b, got_regime, scale)) == ref_fasta
    assert dataclasses.asdict(M2.make_config(regime)) == ref_cfg


def test_mode2_phase_exp_inputs_equal_script(monkeypatch, tmp_path):
    """mode2_phase_exp's reads and its four configurations, in order,
    equal benchmarks/mode2_phase_exp.py's (its 2 Mb genome, the reads cut
    by CUT)."""
    calls = jax_script("mode2_phase_exp", monkeypatch, tmp_path, cut_genome=False, go_on=True)
    assert len(calls) == len(PX.CONFIGS) == 4
    monkeypatch.setattr(M2, "ONT_COVERAGE", M2.ONT_COVERAGE / CUT)
    hap_a, hap_b, _ = M2.make_haplotypes(PX.SIZE)
    port_fasta = fasta_bytes(tmp_path, M2.make_reads(hap_a, hap_b, "ont"))
    for (ref_fasta, ref_cfg, _), (name, overrides) in zip(calls, PX.CONFIGS):
        assert ref_fasta == port_fasta, name
        assert dataclasses.asdict(PX.make_config(overrides)) == ref_cfg, name
    assert [c[1]["assembly"]["mode2_phasing_min_log_p"] for c in calls][1] == 30.0


def test_tiny_scale_bench_run_equals_jax_run_assembly(monkeypatch, tmp_path, capsys):
    """scale_bench's main on the CPU at a 20 kb genome (uniform1, 25 reads:
    12.5x) writes the script's reads and gives the stage hashes and the
    Assembly.fasta of the JAX run_assembly on the same reads under the
    script's configuration, and prints the summary with its grade, then
    the stage seconds."""
    (ref_fasta, _, ref_cfg), = jax_script(
        "scale_bench", monkeypatch, tmp_path, [("SCALE", "1")], reads_cut=2 * CUT)
    port_tmp = tmp_path / "port"
    port_tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(port_tmp))
    monkeypatch.setattr(SB, "BASES_PER_MB", SB.BASES_PER_MB // CUT)
    monkeypatch.setattr(SB, "UNIFORM_BASES_PER_READ", SB.UNIFORM_BASES_PER_READ * 2)
    capsys.readouterr()
    assert SB.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"regime": "uniform1"' in out and '"qv"' in out
    assert "\nstage seconds: {" in out
    (work,) = os.listdir(port_tmp)
    run_dir = os.path.join(port_tmp, work, "run")
    with open(os.path.join(port_tmp, work, "r.fasta"), "rb") as f:
        assert f.read() == ref_fasta

    jax_run = os.path.join(tmp_path, "jax_run")
    JAX_RUN_ASSEMBLY([os.path.join(port_tmp, work, "r.fasta")], jax_run, ref_cfg)
    got, want = stage_hashes(run_dir), stage_hashes(jax_run, JaxRunStore)
    assert got == want and len(got) >= 8
    with open(os.path.join(run_dir, "Assembly.fasta"), "rb") as f, \
            open(os.path.join(jax_run, "Assembly.fasta"), "rb") as g:
        got_fasta = f.read()
        assert got_fasta == g.read() and got_fasta.startswith(b">")


@pytest.mark.parametrize("waves", [2, 4])
def test_roofline_chain_at_waves_equals_waves_1(monkeypatch, waves):
    """kernel_roofline_prepare(waves=2/4) on the CPU, at two of the
    roofline batch's pairs: it takes the argument and its first chain
    output equals waves 1's. On the CPU every waves value runs the same
    plain version, so this checks only that ``waves`` is passed through;
    the waves kernel itself is held to the plain version on the card
    (tests/test_torch_cuda.py::test_bench_roofline_waves_on_card, and
    chip_smoke.py's phase 12 at the whole roofline batch)."""
    orig = PB.roofline_batch
    monkeypatch.setattr(PB, "roofline_batch", lambda seed=11: tuple(
        x[:2].copy() for x in orig(seed)))
    cpu = torch.device("cpu")
    _, _, want = PB.kernel_roofline_prepare(cpu, K0=1, K1=2, waves=1)
    rep, _, got = PB.kernel_roofline_prepare(cpu, K0=1, K1=2, waves=waves)
    assert got == want != 0
    assert rep()[0] > 0


def test_waves_ab_main_line(monkeypatch, capsys):
    """waves_ab's main on the CPU at two pairs and WAVES_AB_REPS=1: a line a
    rep and variant, then the script's JSON keys, speedups by its
    formula."""
    orig = PB.roofline_batch
    monkeypatch.setattr(PB, "roofline_batch", lambda seed=11: tuple(
        x[:2].copy() for x in orig(seed)))
    prep = PB.kernel_roofline_prepare
    monkeypatch.setattr(PB, "kernel_roofline_prepare",
                        lambda device, waves=None: prep(device, K0=1, K1=2, waves=waves))
    monkeypatch.setenv("WAVES_AB_REPS", "1")
    assert WA.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("[waves_ab] rep 0 waves=") for ln in lines) == 3
    line = json.loads(lines[-1])
    assert list(line) == ["waves1_gcells_per_sec", "waves2_gcells_per_sec",
                          "waves4_gcells_per_sec", "speedup_w2", "speedup_w4"]


@pytest.mark.parametrize("module", ["scale_bench", "mode2_scale_bench", "waves_ab",
                                    "mode2_phase_exp"])
def test_device_cuda_without_a_card_exits_non_zero(module):
    """With no card, each module (device cuda, the default) exits non-zero
    before any work and prints nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", f"shasta_tpu_torch.benchmarks.{module}"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr
