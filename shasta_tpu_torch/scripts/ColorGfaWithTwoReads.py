#!/usr/bin/env python
"""Write a Bandage-compatible CSV coloring assembly segments by which
of two oriented reads traverse them
(reference: scripts/ColorGfaWithTwoReads.py).

Usage: ColorGfaWithTwoReads.py <runDir> --readId0 .. --strand0 .. --readId1 .. --strand1 ..
"""
import argparse
import os
import sys

from _common import DEVICE_HELP, attach
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph
from shasta_tpu_torch.graph.detangle import _edge_oriented_reads


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("runDir", nargs="?", default=".")
    parser.add_argument("--readId0", type=int, required=True)
    parser.add_argument("--strand0", type=int, choices=range(2), required=True)
    parser.add_argument("--readId1", type=int, required=True)
    parser.add_argument("--strand1", type=int, choices=range(2), required=True)
    parser.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = parser.parse_args(argv)

    a = attach(args.runDir, args.device)
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    orid0 = 2 * args.readId0 + args.strand0
    orid1 = 2 * args.readId1 + args.strand1
    out = os.path.join(a.run_dir, "GfaTwoReadsColor.csv")
    with open(out, "w") as f:
        f.write("Segment,Color\n")
        for e in range(ag.edge_count):
            if not ag.is_assembled_edge(e):
                continue
            orids = set(_edge_oriented_reads(ag, a.marker_graph, e).tolist())
            has0, has1 = orid0 in orids, orid1 in orids
            color = ("Purple" if has0 and has1 else
                     "Red" if has0 else "Blue" if has1 else "Grey")
            f.write(f"{e},{color}\n")
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
