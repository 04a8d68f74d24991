"""Mode 0 at scale: a ``SCALE`` Mb genome at about 25x, the whole pipeline
on one card, graded against the truth genome (k-mer QV, completeness,
misassemblies: ``utils/accuracy.py``). The port of the JAX system's
``benchmarks/scale_bench.py``.

    [SCALE=5] [REGIME=ont] [ITERATIVE=1] \
        python -m shasta_tpu_torch.benchmarks.scale_bench [--device cuda|cpu]

Regimes (``REGIME``):

- ``uniform1`` (the default): 2,500 reads of 10 kb a Mb, 1 % uniform
  errors (the vectorized error applier), under a hand-set configuration
  (:func:`make_config`).
- ``ont``: ``synth.sample_reads_ont`` at 25x (log-normal lengths, median
  25 kb, sigma 0.55, at least 3 kb; indel-biased errors concentrated in
  homopolymers, about 2.2 % after run-length encoding) under the
  ``Nanopore-May2022`` configuration verbatim. At ``SCALE=5`` the reads
  and the configuration are those of ``chip_smoke.py``'s 5 Mb run.

``ITERATIVE=1`` adds one iterative (pseudo-path) round. The genome is
seed 500, the reads seed 501. The reads go to ``r.fasta`` in a new
``tempfile.mkdtemp()`` directory and the run to ``run`` beside it (both
kept). Prints a line when the reads are written, then the run's summary
as JSON without its stage seconds, with ``accuracy``,
``accuracySeconds`` and ``regime`` added, then ``stage seconds:`` and
the stage seconds as JSON.

``--device``: where the DP runs, ``cuda`` (the default; raises without a
card) or ``cpu`` (the kernels' plain PyTorch version). Tests cut the
size by monkeypatching :data:`BASES_PER_MB` (the read count of
``uniform1`` follows it), never by a flag.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

from shasta_tpu_torch.benchmarks import parse_device

# Bases of genome per unit of SCALE.
BASES_PER_MB = 1_000_000
# uniform1: one read of UNIFORM_READ_LENGTH per UNIFORM_BASES_PER_READ
# bases of genome (2,500 reads a Mb: 25x).
UNIFORM_READ_LENGTH = 10_000
UNIFORM_BASES_PER_READ = 400
# ont: coverage of the genome.
ONT_COVERAGE = 25.0


def knobs():
    """(SCALE, REGIME, ITERATIVE) from the environment, as the script
    reads them: any REGIME but ``ont`` is ``uniform1``'s."""
    env = os.environ
    return (int(env.get("SCALE", "1")), env.get("REGIME", "uniform1"),
            env.get("ITERATIVE", "0") == "1")


def make_genome(scale: int):
    from shasta_tpu_torch.utils import synth

    return synth.random_genome(BASES_PER_MB * scale, seed=500)


def make_reads(genome, regime: str, scale: int):
    """The reads of ``regime`` on ``genome`` (seed 501)."""
    from shasta_tpu_torch.utils import synth

    if regime == "ont":
        return synth.sample_reads_ont(
            genome, ONT_COVERAGE, seed=501, median_length=25000, sigma=0.55, min_length=3000,
        )
    return synth.sample_reads(
        genome, scale * BASES_PER_MB // UNIFORM_BASES_PER_READ, UNIFORM_READ_LENGTH,
        seed=501, error_rate=0.01, both_strands=True, vectorized=True,
    )


def make_config(regime: str, iterative: bool = False):
    """``Nanopore-May2022`` for ``ont``, else the script's hand-set
    configuration; ``iterative`` adds one iterative round."""
    from shasta_tpu_torch.pipeline.config import AssemblyConfig
    from shasta_tpu_torch.pipeline.configurations import get_configuration

    if regime == "ont":
        cfg = AssemblyConfig.from_conf_text(get_configuration("Nanopore-May2022"))
    else:
        cfg = AssemblyConfig()
        cfg.reads.min_read_length = 1000
        cfg.kmers.k = 10
        cfg.kmers.probability = 0.1
        cfg.min_hash.hash_fraction = 0.02
        cfg.min_hash.min_hash_iteration_count = 8
        cfg.min_hash.min_frequency = 2
        cfg.min_hash.max_bucket_size = 60
        cfg.align.min_aligned_marker_count = 40
        cfg.align.max_skip = 60
        cfg.align.max_drift = 40
        cfg.align.max_trim = 60
        cfg.read_graph.max_alignment_count = 8
        cfg.marker_graph.min_coverage = 0
    if iterative:
        cfg.assembly.iterative = True
        cfg.assembly.iterative_iteration_count = 1
    return cfg


def grade(run_dir: str, genome) -> dict:
    """``assembly_metrics(k=21)`` of the run's Assembly.fasta against the
    genome."""
    from shasta_tpu_torch.utils import accuracy as AC

    contigs = AC.parse_fasta_contigs(os.path.join(run_dir, "Assembly.fasta"))
    return AC.assembly_metrics(contigs, genome, k=21)


def print_summary(summary: dict) -> None:
    """The summary without its stage seconds, then the stage seconds."""
    print(json.dumps({k: v for k, v in summary.items() if k != "stageSeconds"}, indent=1),
          flush=True)
    print("stage seconds:", json.dumps(
        {k: round(v, 1) for k, v in summary["stageSeconds"].items()}, indent=1), flush=True)


def main(argv=None) -> int:
    from shasta_tpu_torch.pipeline.assemble import run_assembly
    from shasta_tpu_torch.utils import synth

    device = parse_device("scale_bench", "Mode 0 at SCALE Mb, graded.", argv)
    scale, regime, iterative = knobs()
    t0 = time.monotonic()
    genome = make_genome(scale)
    reads = make_reads(genome, regime, scale)
    tmp = tempfile.mkdtemp()
    fa = os.path.join(tmp, "r.fasta")
    synth.write_fasta(fa, reads)
    n_bases = sum(len(r) for r in reads)
    print(f"[{time.monotonic() - t0:.0f}s] {len(reads)} reads written "
          f"({n_bases / 1e6:.0f} Mb)", flush=True)
    del reads

    run_dir = os.path.join(tmp, "run")
    summary = run_assembly([fa], run_dir, make_config(regime, iterative), device=device)

    t_acc = time.monotonic()
    summary["accuracy"] = grade(run_dir, genome)
    summary["accuracySeconds"] = round(time.monotonic() - t_acc, 1)
    summary["regime"] = regime
    print_summary(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
