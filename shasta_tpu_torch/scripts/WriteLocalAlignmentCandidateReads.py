#!/usr/bin/env python
"""Write a FASTA with all reads within a distance bound of a start
oriented read in the alignment candidate graph
(reference: scripts/WriteLocalAlignmentCandidateReads.py).

Usage: WriteLocalAlignmentCandidateReads.py <runDir> --readId N --strand S --maxDistance D
"""
import argparse
import os
import sys

import numpy as np

from _common import DEVICE_HELP, attach
from shasta_tpu_torch.data import bases as B


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("runDir", nargs="?", default=".")
    parser.add_argument("--readId", type=int, required=True)
    parser.add_argument("--strand", type=int, choices=range(2), required=True)
    parser.add_argument("--maxDistance", type=int, required=True)
    parser.add_argument("--allowChimericReads", action="store_true")
    parser.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = parser.parse_args(argv)

    a = attach(args.runDir, args.device)
    c = a.candidates
    # Adjacency over candidate pairs as oriented reads (both strands).
    o0 = 2 * c.read_id0.astype(np.int64)
    o1 = np.where(c.same_strand, 2 * c.read_id1, 2 * c.read_id1 + 1).astype(np.int64)
    # Strand-symmetric copy.
    u = np.concatenate([o0, o1, o0 ^ 1, o1 ^ 1])
    v = np.concatenate([o1, o0, o1 ^ 1, o0 ^ 1])
    order = np.argsort(u, kind="stable")
    us, vs = u[order], v[order]
    n_or = 2 * a.reads.read_count
    off = np.searchsorted(us, np.arange(n_or + 1))

    start = 2 * args.readId + args.strand
    dist = {start: 0}
    frontier = [start]
    while frontier:
        nxt = []
        for x in frontier:
            for y in vs[off[x]:off[x + 1]].tolist():
                if not args.allowChimericReads and a.reads.is_chimeric[y // 2]:
                    continue
                if y not in dist and dist[x] < args.maxDistance:
                    dist[y] = dist[x] + 1
                    nxt.append(y)
        frontier = nxt
    name = (f"LocalAlignmentCandidates-{args.readId}-{args.strand}-"
            f"{args.maxDistance}.fasta")
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
