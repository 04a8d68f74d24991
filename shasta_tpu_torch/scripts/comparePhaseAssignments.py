#!/usr/bin/env python
"""Compare two mode-2 phase assignments
(reference: scripts/comparePhaseAssignments.py).

Reads two Assembly-Phased.csv files (Segment,Length,Haplotype,
PhasedComponent) and reports per-component agreement, allowing a
global haplotype flip within each phased component (haplotype labels
are arbitrary per component; only the partition matters).

Usage: comparePhaseAssignments.py phasedA.csv phasedB.csv
"""
import csv
import sys
from collections import defaultdict


def load(path):
    rows = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            hap = row.get("Haplotype", "")
            comp = row.get("PhasedComponent", "")
            if hap != "" and comp != "":
                rows[row["Segment"]] = (int(comp), int(hap))
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 2:
        print(__doc__)
        return 2
    a, b = load(argv[0]), load(argv[1])
    shared = sorted(set(a) & set(b))
    if not shared:
        print("No shared phased segments.")
        return 1

    by_comp = defaultdict(list)
    for seg in shared:
        by_comp[(a[seg][0], b[seg][0])].append(seg)

    agree = 0
    total = 0
    for (_ca, _cb), segs in sorted(by_comp.items()):
        same = sum(1 for s in segs if a[s][1] == b[s][1])
        # Haplotype labels are arbitrary per component: count the
        # better of identity and global flip.
        best = max(same, len(segs) - same)
        agree += best
        total += len(segs)
        print(f"Component pair {_ca}/{_cb}: {len(segs)} segments, "
              f"{best}/{len(segs)} phase agreement")
    print(f"\nOverall: {agree}/{total} "
          f"({agree * 100.0 / total:.1f}%) segments agree in phase "
          f"(up to per-component flips); {len(shared)} shared phased "
          f"segments, {len(a)} in A, {len(b)} in B.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
