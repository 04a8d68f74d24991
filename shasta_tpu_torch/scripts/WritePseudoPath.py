#!/usr/bin/env python
"""Write the pseudo-path (journey through assembly graph segments) of
an oriented read (reference: scripts/WritePseudoPath.py).

Usage: WritePseudoPath.py <runDir> --readId N --strand S
"""
import argparse
import sys

from _common import DEVICE_HELP, attach
from shasta_tpu_torch.graph.mode3 import create_mode3_graph


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("runDir", nargs="?", default=".")
    parser.add_argument("--readId", type=int, required=True)
    parser.add_argument("--strand", type=int, choices=range(2), required=True)
    parser.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = parser.parse_args(argv)

    a = attach(args.runDir, args.device)
    m3 = create_mode3_graph(a.markers, a.marker_graph, min_link_coverage=1)
    orid = 2 * args.readId + args.strand
    journey = m3.journey(orid)
    print(f"Pseudo-path of oriented read {args.readId}-{args.strand}: "
          f"{journey.shape[0]} segments")
    print("Position,Segment")
    for p, s in enumerate(journey.tolist()):
        print(f"{p},{s}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
