#!/usr/bin/env python
"""Write Assembly-BothStrands.gfa from a stored run
(reference: scripts/WriteGfaBothStrands.py)."""
import os
import sys

from _common import open_run
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph, write_gfa1


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    out = os.path.join(a.run_dir, "Assembly-BothStrands.gfa")
    write_gfa1(out, ag, a.config.kmers.k, both_strands=True)
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
