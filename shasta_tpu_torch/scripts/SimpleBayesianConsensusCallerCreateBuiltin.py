#!/usr/bin/env python
"""Install a Bayesian consensus model CSV as a named built-in model
(reference: scripts/SimpleBayesianConsensusCallerCreateBuiltin.py,
which generated a C++ header; here the built-ins are data files under
shasta_tpu_torch/consensus/models/).

Usage: SimpleBayesianConsensusCallerCreateBuiltin.py <model.csv> <name>
"""
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 2:
        print(__doc__)
        return 1
    src, name = argv[0], argv[1]

    models_dir = os.environ.get("SHASTA_TORCH_BAYESIAN_MODEL_DIR", "")
    if not models_dir:
        import shasta_tpu_torch.consensus as C

        models_dir = os.path.join(os.path.dirname(C.__file__), "models")
    os.makedirs(models_dir, exist_ok=True)
    dst = os.path.join(models_dir, f"SimpleBayesianConsensusCaller-{name}.csv")
    shutil.copy(src, dst)

    # Verify it loads.
    from shasta_tpu_torch.consensus.caller import get_consensus_caller

    get_consensus_caller(f"Bayesian:{name}")
    print(f"Installed and verified model Bayesian:{name} at {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
