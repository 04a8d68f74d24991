#!/usr/bin/env python
"""Write Assembly.fasta from a stored run (reference: scripts/WriteFasta.py)."""
import os
import sys

from _common import open_run
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph, write_fasta


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    out = os.path.join(a.run_dir, "Assembly.fasta")
    write_fasta(out, ag)
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
