"""Mode 2 (phased diploid) at scale: a ``SCALE`` Mb diploid genome with a
het SNP every 700 bases, the whole mode-2 pipeline on one card, graded
against the two haplotypes. The port of the JAX system's
``benchmarks/mode2_scale_bench.py``.

    [SCALE=5] [REGIME=ont] \
        python -m shasta_tpu_torch.benchmarks.mode2_scale_bench [--device cuda|cpu]

Regimes (``REGIME``):

- ``uniform1`` (the default): 1,250 reads of 10 kb a Mb on each
  haplotype (about 25x in all), 1 % uniform errors (the loop error
  applier, whose random stream this fixes), under a hand-set mode-2
  configuration (:func:`make_config`).
- ``ont``: ``synth.sample_reads_ont`` at 20x on each haplotype (median
  25 kb, sigma 0.55, at least 11 kb), about 40x in all, under the
  ``Nanopore-Phased-May2022`` configuration verbatim.

Haplotype A is seed 701; B is A with the base at 350, 1050, 1750, ...
replaced by one of the three others (seed 700); the reads are seeds 702
(A) and 703 (B). Grading: ``assembly_metrics(k=21)`` of
Assembly-Haploid.fasta against both haplotypes (``accuracy``), and
``diploid_phasing_metrics`` of Assembly-Phased.fasta's ``PR.*``
segments (``phasing``: only they claim a phase) and of all its segments
(``phasingAllSegments``). Output and files as ``scale_bench``'s. Tests
cut the size by monkeypatching :data:`BASES_PER_MB` or the reads'
constants (:data:`UNIFORM_BASES_PER_READ`, :data:`ONT_COVERAGE`).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

from shasta_tpu_torch.benchmarks import parse_device
from shasta_tpu_torch.benchmarks.scale_bench import print_summary

# Bases of each haplotype per unit of SCALE.
BASES_PER_MB = 1_000_000
# uniform1: reads of UNIFORM_READ_LENGTH, one per UNIFORM_BASES_PER_READ
# bases on each haplotype (1,250 a Mb: 12.5x each).
UNIFORM_READ_LENGTH = 10_000
UNIFORM_BASES_PER_READ = 800
# ont: coverage of each haplotype.
ONT_COVERAGE = 20.0
# A het SNP at SNP_FIRST, then every SNP_SPACING bases.
SNP_FIRST = 350
SNP_SPACING = 700


def knobs():
    """(SCALE, REGIME) from the environment, as the script reads them."""
    return int(os.environ.get("SCALE", "1")), os.environ.get("REGIME", "uniform1")


def make_haplotypes(size: int):
    """(hapA, hapB, snp_positions) of a ``size``-base diploid genome."""
    from shasta_tpu_torch.utils import synth

    rng = np.random.default_rng(700)
    hap_a = synth.random_genome(size, seed=701)
    hap_b = hap_a.copy()
    snp = np.arange(SNP_FIRST, size, SNP_SPACING)
    hap_b[snp] = (hap_a[snp] + 1 + rng.integers(0, 3, snp.shape[0])) % 4
    return hap_a, hap_b, snp


def make_reads(hap_a, hap_b, regime: str, scale: int = 1):
    """The reads of ``regime``: A's (seed 702), then B's (seed 703)."""
    from shasta_tpu_torch.utils import synth

    reads = []
    if regime == "ont":
        for hap, seed in ((hap_a, 702), (hap_b, 703)):
            reads += synth.sample_reads_ont(
                hap, ONT_COVERAGE, seed=seed, median_length=25000, sigma=0.55, min_length=11000,
            )
    else:
        n = scale * BASES_PER_MB // UNIFORM_BASES_PER_READ
        for hap, seed in ((hap_a, 702), (hap_b, 703)):
            reads += synth.sample_reads(
                hap, n, UNIFORM_READ_LENGTH, seed=seed, error_rate=0.01, both_strands=True,
            )
    return reads


def make_config(regime: str):
    """``Nanopore-Phased-May2022`` for ``ont``, else the script's hand-set
    mode-2 configuration."""
    from shasta_tpu_torch.pipeline.config import AssemblyConfig
    from shasta_tpu_torch.pipeline.configurations import get_configuration

    if regime == "ont":
        return AssemblyConfig.from_conf_text(get_configuration("Nanopore-Phased-May2022"))
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
    cfg.read_graph.strand_separation_method = 2
    cfg.marker_graph.min_coverage = 0
    cfg.marker_graph.min_edge_coverage = 4
    cfg.marker_graph.min_edge_coverage_per_strand = 1
    cfg.assembly.mode = 2
    return cfg


def phased_segments(run_dir: str):
    """(all of Assembly-Phased.fasta's segments, its ``PR.*`` ones)."""
    from shasta_tpu_torch.utils import accuracy as AC

    names, phased = AC.parse_fasta_named(os.path.join(run_dir, "Assembly-Phased.fasta"))
    return phased, [s for n, s in zip(names, phased) if n.startswith("PR.")]


def grade(run_dir: str, hap_a, hap_b) -> dict:
    """``accuracy``, ``phasing`` and ``phasingAllSegments``."""
    from shasta_tpu_torch.utils import accuracy as AC

    haploid = AC.parse_fasta_contigs(os.path.join(run_dir, "Assembly-Haploid.fasta"))
    phased, pr_only = phased_segments(run_dir)
    return {
        "accuracy": AC.assembly_metrics(haploid, [hap_a, hap_b], k=21),
        "phasing": AC.diploid_phasing_metrics(pr_only, hap_a, hap_b, k=21),
        "phasingAllSegments": AC.diploid_phasing_metrics(phased, hap_a, hap_b, k=21),
    }


def main(argv=None) -> int:
    from shasta_tpu_torch.pipeline.assemble import run_assembly
    from shasta_tpu_torch.utils import synth

    device = parse_device("mode2_scale_bench", "Mode 2 on a SCALE Mb diploid genome, "
                          "graded.", argv)
    scale, regime = knobs()
    t0 = time.monotonic()
    hap_a, hap_b, snp = make_haplotypes(BASES_PER_MB * scale)
    reads = make_reads(hap_a, hap_b, regime, scale)
    tmp = tempfile.mkdtemp()
    fa = os.path.join(tmp, "r.fasta")
    synth.write_fasta(fa, reads)
    print(f"[{time.monotonic() - t0:.0f}s] diploid reads written "
          f"({sum(len(r) for r in reads) / 1e6:.0f} Mb, {snp.shape[0]} het SNPs)", flush=True)
    del reads

    run_dir = os.path.join(tmp, "run")
    summary = run_assembly([fa], run_dir, make_config(regime), device=device)

    t_acc = time.monotonic()
    summary.update(grade(run_dir, hap_a, hap_b))
    summary["accuracySeconds"] = round(time.monotonic() - t_acc, 1)
    summary["regime"] = regime
    print_summary(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
