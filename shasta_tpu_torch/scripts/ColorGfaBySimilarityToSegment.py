#!/usr/bin/env python
"""Write a Bandage-compatible CSV coloring assembly segments by their
oriented-read (Jaccard) similarity to a chosen segment
(reference: scripts/ColorGfaBySimilarityToSegment.py).

Usage: ColorGfaBySimilarityToSegment.py <runDir> --segmentId N [--minJaccard 0.3]
"""
import argparse
import os
import sys

import numpy as np

from _common import DEVICE_HELP, attach
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph
from shasta_tpu_torch.graph.detangle import _edge_oriented_reads


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("runDir", nargs="?", default=".")
    parser.add_argument("--segmentId", type=int, required=True)
    parser.add_argument("--minJaccard", type=float, default=0.3)
    parser.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = parser.parse_args(argv)

    a = attach(args.runDir, args.device)
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    ref = _edge_oriented_reads(ag, a.marker_graph, args.segmentId)
    out = os.path.join(a.run_dir, f"GfaSimilarity-{args.segmentId}.csv")
    with open(out, "w") as f:
        f.write("Segment,Color,Jaccard\n")
        for e in range(ag.edge_count):
            if not ag.is_assembled_edge(e):
                continue
            orids = _edge_oriented_reads(ag, a.marker_graph, e)
            inter = np.intersect1d(ref, orids).shape[0]
            union = np.union1d(ref, orids).shape[0]
            j = inter / union if union else 0.0
            color = "Red" if e == args.segmentId else (
                "Orange" if j >= args.minJaccard else "Grey")
            f.write(f"{e},{color},{j:.3f}\n")
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
