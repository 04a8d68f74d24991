#!/usr/bin/env python
"""Write a FASTA with all reads within a distance bound of a start
oriented read in the read graph
(reference: scripts/WriteLocalReadGraphReads.py).

Usage: WriteLocalReadGraphReads.py <runDir> --readId N --strand S --maxDistance D
"""
import argparse
import os
import sys

from _common import DEVICE_HELP, attach
from shasta_tpu_torch.data import bases as B


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("runDir", nargs="?", default=".")
    parser.add_argument("--readId", type=int, required=True)
    parser.add_argument("--strand", type=int, choices=range(2), required=True)
    parser.add_argument("--maxDistance", type=int, required=True)
    parser.add_argument("--allowChimericReads", action="store_true")
    parser.add_argument("--allowCrossStrandEdges", action="store_true")
    parser.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = parser.parse_args(argv)

    a = attach(args.runDir, args.device)
    g = a.read_graph
    start = 2 * args.readId + args.strand
    dist = {start: 0}
    frontier = [start]
    while frontier:
        nxt = []
        for u in frontier:
            edges, others = g.neighbors(u)
            for e, v in zip(edges.tolist(), others.tolist()):
                if not args.allowCrossStrandEdges and g.crosses_strands[e]:
                    continue
                if not args.allowChimericReads and a.reads.is_chimeric[v // 2]:
                    continue
                if v not in dist and dist[u] < args.maxDistance:
                    dist[v] = dist[u] + 1
                    nxt.append(v)
        frontier = nxt
    name = f"LocalReadGraph-{args.readId}-{args.strand}-{args.maxDistance}.fasta"
    name = os.path.join(a.run_dir, name)
    with open(name, "w") as f:
        for orid in sorted(dist):
            rid, s = orid // 2, orid % 2
            seq = a.reads.read_raw(rid, s)
            f.write(f">{a.reads.names[rid]} distance {dist[orid]}\n")
            f.write(B.decode_to_str(seq) + "\n")
    print(f"{len(dist)} oriented reads within distance {args.maxDistance}. "
          f"Wrote {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
