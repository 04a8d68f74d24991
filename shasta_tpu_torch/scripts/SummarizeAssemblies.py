#!/usr/bin/env python
"""Tabulate AssemblySummary.json across run directories
(reference: scripts/SummarizeAssemblies.py).

Usage: SummarizeAssemblies.py <runDir> [<runDir> ...]
"""
import json
import os
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    rows = []
    for d in argv:
        p = os.path.join(d, "AssemblySummary.json")
        if not os.path.exists(p):
            print(f"{d}: no AssemblySummary.json", file=sys.stderr)
            continue
        with open(p) as f:
            rows.append((d, json.load(f)))

    fields = [
        "readCount", "markerCount", "alignmentCount",
        "markerGraphVertexCount", "assembledSegmentCount",
        "totalAssembledSegmentLength", "assembledSegmentN50",
        "elapsedSeconds",
    ]
    print("RunDirectory," + ",".join(fields))
    for d, s in rows:
        print(d + "," + ",".join(str(s.get(k, "")) for k in fields))
    return 0


if __name__ == "__main__":
    sys.exit(main())
