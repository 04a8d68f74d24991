#!/usr/bin/env python
"""Parse every built-in configuration (reference:
scripts/CheckConfigurations.py)."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
from shasta_tpu_torch.pipeline.config import AssemblyConfig
from shasta_tpu_torch.pipeline.configurations import CONFIGURATIONS


def main(argv=None) -> int:
    for name, text in CONFIGURATIONS.items():
        cfg = AssemblyConfig.from_conf_text(text)
        print(f"{name}: ok (k={cfg.kmers.k}, mode={cfg.assembly.mode}, "
              f"caller={cfg.assembly.consensus_caller})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
