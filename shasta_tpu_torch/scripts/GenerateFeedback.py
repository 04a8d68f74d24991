#!/usr/bin/env python
"""Post-run QC feedback with tuning suggestions
(reference: scripts/GenerateFeedback.py).

Reads AssemblySummary.json + shasta.conf from a finished run and
prints assembly statistics plus parameter suggestions when the
candidate or good-alignment yield is low, following the reference's
assembly -> feedback -> assembly loop.

Usage:
    GenerateFeedback.py --assemblyDirectory DIR --genomeSizeMbp 3000
(with no --genomeSizeMbp, asks interactively.)
"""
import argparse
import configparser
import json
import os
import sys


def analyze(run_dir: str, genome_size: int) -> None:
    with open(os.path.join(run_dir, "AssemblySummary.json")) as f:
        s = json.load(f)

    n_reads = s["readCount"]
    n_candidates = s["alignmentCandidateCount"]
    n_good = s["alignmentCount"]
    isolated_fraction = s.get("isolatedReadCount", 0) / max(1, n_reads)

    print()
    print(f"Number of reads used = {n_reads}")
    print(f"Isolated reads fraction = {isolated_fraction:.2f}")
    print(f"Number of alignment candidates = {n_candidates}")
    print(f"Number of good alignments = {n_good}")
    print()
    total = s["totalAssembledSegmentLength"]
    print(f"Genome fraction assembled = {total * 100 / genome_size:.2f} %")
    print(f"Longest assembled segment length = "
          f"{s['longestAssembledSegmentLength']}")
    print(f"Assembled segments N50 = {s['assembledSegmentN50']}")
    print()

    config = configparser.ConfigParser()
    config.read(os.path.join(run_dir, "shasta.conf"))

    print("Feedback, if any:")
    if n_candidates / max(1, n_reads) < 20:
        print("MinHash phase did not generate enough alignment candidates.")
        print("Try the following in order:")
        print("  (Suggestion) Increase `MinHash.minHashIterationCount` "
              "by 10, up to a maximum of 100.")
        try:
            if int(config["MinHash"]["m"]) == 4:
                print("  (Suggestion) Decrease `MinHash.m` to 3.")
        except (KeyError, ValueError):
            pass
    elif n_good / max(1, n_reads) < 5 or isolated_fraction > 0.5:
        print("Not enough good alignments were generated per read. "
              "Try relaxing the definition of what makes a good alignment.")
        print("Try the following in order:")
        print("  (Suggestion) Decrease `Align.minAlignedFraction` by 0.05, "
              "up to a minimum of 0.2.")
        print("  (Suggestion) Decrease `Align.minAlignedMarkerCount` by 20, "
              "up to a minimum of 200.")
        print("  (Suggestion) Increase `Align.maxSkip` & `Align.maxDrift` "
              "by 10, to allow for larger gaps in alignments.")
    print()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--assemblyDirectory", required=True)
    ap.add_argument("--genomeSizeMbp", type=float)
    args = ap.parse_args(argv)
    if args.genomeSizeMbp is None:
        print("What is the approximate genome size in megabases (Mbp)?")
        args.genomeSizeMbp = float(input("Genome size (Mbp): "))
    analyze(args.assemblyDirectory, int(args.genomeSizeMbp * 1_000_000))
    return 0


if __name__ == "__main__":
    sys.exit(main())
