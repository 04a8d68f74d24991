#!/usr/bin/env python
"""Generate a starter assembly configuration, interactively or from
flags (reference: scripts/GenerateConfig.py).

The generated config mirrors the reference's starter recipe: permissive
alignment criteria so read-graph creation method 2 can pick the real
cutoffs from the observed alignment-statistic distributions, 60x
(or 80x for older basecallers) desired coverage, and a Bayesian
consensus caller matched to the basecaller generation.

Usage (non-interactive):
    GenerateConfig.py --genomeSizeMbp 0.4 [--tech ont|pacbio]
        [--basecaller 1|2|3] [--ultralong] [--no-detangle]
        [--out generatedShasta.conf]

With no flags, asks the same questions interactively.
"""
import argparse
import sys


def generate_config(genome_size, basecaller_id, enable_detangling, ultralong):
    min_read_length = 40000 if ultralong else 10000
    lines = []

    def section(name, **kv):
        lines.append(f"[{name}]")
        for k, v in kv.items():
            lines.append(f"{k} = {v}")
        lines.append("")

    reads = dict(
        minReadLength=min_read_length,
        desiredCoverage=genome_size * 60,
        noCache="True",
    )
    consensus = "Bayesian:guppy-3.6.0-a"
    if basecaller_id in (2, 3):
        reads["desiredCoverage"] = genome_size * 80
        consensus = "Bayesian:guppy-3.0.5-a" if basecaller_id == 2 else "Modal"

    section("Reads", **reads)
    section("Kmers", k=10)
    section(
        "MinHash",
        minHashIterationCount=10,
        minBucketSize=5,
        maxBucketSize=30,
        minFrequency=5,
    )
    # Permissive alignment criteria: read-graph creation method 2
    # derives the real cutoffs from the observed distributions.
    section(
        "Align",
        alignMethod=3,
        downsamplingFactor=0.05,
        matchScore=6,
        maxSkip=100,
        maxDrift=100,
        maxTrim=100,
        minAlignedFraction=0.1,
        minAlignedMarkerCount=10,
        **{"sameChannelReadAlignment.suppressDeltaThreshold": 30},
    )
    section("ReadGraph", creationMethod=2)
    section(
        "MarkerGraph",
        simplifyMaxLength="10,100,1000,10000,100000",
        crossEdgeCoverageThreshold=3,
        minCoverage=0,
    )
    assembly = dict(consensusCaller=consensus)
    if enable_detangling:
        assembly["detangleMethod"] = 2
    section("Assembly", **assembly)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genomeSizeMbp", type=float)
    ap.add_argument("--tech", choices=["ont", "pacbio"], default="ont")
    ap.add_argument("--basecaller", type=int, choices=[1, 2, 3])
    ap.add_argument("--ultralong", action="store_true")
    ap.add_argument("--no-detangle", action="store_true")
    ap.add_argument("--out", default="generatedShasta.conf")
    args = ap.parse_args(argv)

    if args.genomeSizeMbp is None:
        print("Approximate genome size in megabases (e.g. 3000 for 3 Gbp):")
        args.genomeSizeMbp = float(input("Genome size (Mbp): "))
        tech = input("Technology [1=ONT (default), 2=PacBio]: ").strip()
        args.tech = "pacbio" if tech == "2" else "ont"
        if args.tech == "ont":
            bc = input(
                "Basecaller [1=Guppy>=3.6.0 (default), 2=Guppy<3.6.0, 3=other]: "
            ).strip()
            args.basecaller = int(bc) if bc else 1
        ul = input("Ultra-long reads? [y/N]: ").strip().lower()
        args.ultralong = ul == "y"
        dt = input("Enable detangling? [Y/n]: ").strip().lower()
        args.no_detangle = dt == "n"

    basecaller = args.basecaller if args.tech == "ont" else 3
    if basecaller is None:
        basecaller = 1
    text = generate_config(
        int(args.genomeSizeMbp * 1_000_000),
        basecaller,
        not args.no_detangle,
        args.ultralong,
    )
    with open(args.out, "w") as f:
        f.write(text)
    print(f"Configuration written to {args.out}")
    print("After assembling, run GenerateFeedback.py for tuning suggestions.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
