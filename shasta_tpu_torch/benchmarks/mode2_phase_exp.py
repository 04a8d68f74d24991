"""Four phasing thresholds on one diploid genome: the PhasingGraph's
Bayesian acceptance (``mode2_phasing_min_log_p``, dB) and its least
count of concordant reads an edge (``mode2_phasing_min_concordant_read_count``),
each at the reference's default and raised, all runs in one process.
The port of the JAX system's ``benchmarks/mode2_phase_exp.py``.

    python -m shasta_tpu_torch.benchmarks.mode2_phase_exp [--device cuda|cpu]

The genome is ``mode2_scale_bench``'s at :data:`SIZE` bases (2 Mb) and
its ``ont`` reads (2 x 20x); every run is ``Nanopore-Phased-May2022``
with :data:`CONFIGS`' overrides. Prints a line when the reads are
written, then one JSON line per configuration: its seconds, phased
bubbles, diploid N50, the ``PR.*`` segments' count, mean purity and het
k-mer recall (``diploid_phasing_metrics``), and their block switches,
isolated flips and het SNPs (``phasing_switch_errors``). Tests cut the
size by monkeypatching :data:`SIZE`.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

SIZE = 2_000_000

CONFIGS = [
    ("ref_defaults", {}),
    ("minlogp30", {"mode2_phasing_min_log_p": 30.0}),
    ("concordant4", {"mode2_phasing_min_concordant_read_count": 4}),
    ("both", {"mode2_phasing_min_log_p": 30.0,
              "mode2_phasing_min_concordant_read_count": 4}),
]


def make_config(overrides: dict):
    """``Nanopore-Phased-May2022`` with ``overrides`` set on its
    ``assembly`` section."""
    from shasta_tpu_torch.benchmarks.mode2_scale_bench import make_config as mode2_config

    cfg = mode2_config("ont")
    for k, v in overrides.items():
        setattr(cfg.assembly, k, v)
    return cfg


def main(argv=None) -> int:
    from shasta_tpu_torch.benchmarks import mode2_scale_bench as M2
    from shasta_tpu_torch.benchmarks import parse_device
    from shasta_tpu_torch.pipeline.assemble import run_assembly
    from shasta_tpu_torch.utils import accuracy as AC
    from shasta_tpu_torch.utils import synth

    device = parse_device("mode2_phase_exp", "Four phasing thresholds on a diploid genome.",
                          argv)
    hap_a, hap_b, _snp = M2.make_haplotypes(SIZE)
    reads = M2.make_reads(hap_a, hap_b, "ont")
    tmp = tempfile.mkdtemp()
    fa = os.path.join(tmp, "r.fasta")
    synth.write_fasta(fa, reads)
    print(f"[exp] {len(reads)} reads, {sum(len(r) for r in reads) / 1e6:.0f} Mb", flush=True)
    del reads

    for name, overrides in CONFIGS:
        run_dir = os.path.join(tmp, "run_" + name)
        t0 = time.monotonic()
        s = run_assembly([fa], run_dir, make_config(overrides), device=device)
        dt = time.monotonic() - t0
        _phased, pr = M2.phased_segments(run_dir)
        ph = AC.diploid_phasing_metrics(pr, hap_a, hap_b, k=21)
        sw = AC.phasing_switch_errors(pr, hap_a, hap_b, k=21)
        print(json.dumps({
            "config": name,
            "elapsed": round(dt, 1),
            "phasedBubbles": s.get("phasedBubbleCount"),
            "diploidN50": s.get("diploidN50"),
            "prSegments": len(pr),
            "meanPurity": ph["meanPurity"],
            "hetKmerRecall": ph["hetKmerRecall"],
            "blockSwitches": sw["blockSwitches"],
            "isolatedFlips": sw["isolatedFlips"],
            "hetSnps": sw["informativeSites"] // 21,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
