#!/usr/bin/env python
"""Run several assemblies of the same input under different configs
(reference: scripts/RunAssemblies.py).

Usage: RunAssemblies.py --input reads.fasta [reads2.fasta ...]
           --config NAME_OR_PATH [NAME_OR_PATH ...] --outDir DIR

Creates DIR/<configName>/ per config and prints a comparison table.
"""
import argparse
import json
import os
import sys

from _common import DEVICE_HELP


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--input", nargs="+", required=True)
    ap.add_argument("--config", nargs="+", required=True)
    ap.add_argument("--outDir", default="RunAssemblies")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    from shasta_tpu_torch.pipeline.assemble import run_assembly
    from shasta_tpu_torch.pipeline.config import AssemblyConfig
    from shasta_tpu_torch.pipeline.configurations import get_configuration

    rows = []
    for name in args.config:
        if os.path.exists(name):
            config = AssemblyConfig.from_conf_file(name)
            stem = os.path.splitext(os.path.basename(name))[0]
        else:
            config = AssemblyConfig.from_conf_text(get_configuration(name))
            stem = name
        run_dir = os.path.join(args.outDir, stem)
        print(f"=== Assembling under {stem} -> {run_dir}")
        run_assembly(args.input, run_dir, config, device=args.device)
        with open(os.path.join(run_dir, "AssemblySummary.json")) as f:
            s = json.load(f)
        rows.append((stem, s))

    print(f"\n{'Config':30} {'Segments':>9} {'Total':>12} {'N50':>10}")
    for stem, s in rows:
        print(f"{stem:30} {s['assembledSegmentCount']:9} "
              f"{s['totalAssembledSegmentLength']:12} "
              f"{s['assembledSegmentN50']:10}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
