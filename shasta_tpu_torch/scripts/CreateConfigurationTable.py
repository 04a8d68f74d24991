#!/usr/bin/env python
"""Round-trip the built-in configuration table: write every built-in
configuration to <outDir>/<name>.conf and verify each parses back
(reference: scripts/CreateConfigurationTable.py, which generated
ConfigurationTable.cpp from conf/*.conf — here the table is the
source of truth and the conf files are generated from it).

Usage: CreateConfigurationTable.py [outDir]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from shasta_tpu_torch.pipeline.config import AssemblyConfig
from shasta_tpu_torch.pipeline.configurations import CONFIGURATIONS


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    out_dir = argv[0] if argv else "conf-generated"
    os.makedirs(out_dir, exist_ok=True)
    for name, text in sorted(CONFIGURATIONS.items()):
        path = os.path.join(out_dir, f"{name}.conf")
        with open(path, "w") as f:
            f.write(text.strip() + "\n")
        AssemblyConfig.from_conf_file(path)  # must parse
    print(f"Wrote and verified {len(CONFIGURATIONS)} configurations in {out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
