#!/usr/bin/env python
"""Write the marker graph path of an oriented read: the marker graph
vertex visited at each marker ordinal
(reference: scripts/WriteOrientedReadPath.py).

Usage: WriteOrientedReadPath.py <runDir> --readId N --strand S
"""
import argparse
import sys

from _common import DEVICE_HELP, attach


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("runDir", nargs="?", default=".")
    parser.add_argument("--readId", type=int, required=True)
    parser.add_argument("--strand", type=int, choices=range(2), required=True)
    parser.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = parser.parse_args(argv)

    a = attach(args.runDir, args.device)
    orid = 2 * args.readId + args.strand
    lo, hi = a.markers.offsets[orid], a.markers.offsets[orid + 1]
    vt = a.marker_graph.vertex_table[lo:hi]
    print("Ordinal,VertexId")
    for o, v in enumerate(vt.tolist()):
        if v >= 0:
            print(f"{o},{v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
