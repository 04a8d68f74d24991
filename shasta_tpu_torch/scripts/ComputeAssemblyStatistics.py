#!/usr/bin/env python
"""Print assembly statistics for a stored run
(reference: scripts/ComputeAssemblyStatistics.py)."""
import json
import sys

from _common import open_run
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph, assembly_statistics


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    print(json.dumps(assembly_statistics(ag), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
