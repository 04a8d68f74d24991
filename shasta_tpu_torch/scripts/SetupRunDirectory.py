#!/usr/bin/env python
"""Create a run directory ready for stage-wise assembly
(reference: scripts/SetupRunDirectory.py).

Creates the directory, its Data/ stage store, and an effective
shasta.conf (from --config, a built-in name or a conf file path).

Usage: SetupRunDirectory.py <runDir> [--config NAME_OR_PATH]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("runDir")
    ap.add_argument("--config")
    args = ap.parse_args(argv)

    from shasta_tpu_torch.pipeline.config import AssemblyConfig

    if args.config and os.path.exists(args.config):
        config = AssemblyConfig.from_conf_file(args.config)
    elif args.config:
        from shasta_tpu_torch.pipeline.configurations import get_configuration

        config = AssemblyConfig.from_conf_text(get_configuration(args.config))
    else:
        config = AssemblyConfig()

    os.makedirs(os.path.join(args.runDir, "Data"), exist_ok=True)
    config.write_conf(os.path.join(args.runDir, "shasta.conf"))
    print(f"Run directory {args.runDir} ready (Data/ + shasta.conf).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
