#!/usr/bin/env python
"""Generate Bandage label + color CSVs from a PAF alignment of
assembled segments to a reference
(reference: scripts/generateBandageLabelsFromAlignment.py).

Usage: generateBandageLabelsFromAlignment.py <alignment.paf> <outPrefix>
"""
import sys
import zlib

_COLORS = [
    "sea green", "tomato", "dark orange", "cornflower blue", "gold",
    "orchid", "steel blue", "firebrick", "olive drab", "teal",
    "slate blue", "chocolate", "cadet blue", "indian red", "dark khaki",
    "medium purple", "rosy brown", "dark sea green", "peru", "plum",
    "light sea green", "salmon", "dark cyan", "tan",
]


def color_of(ref_name: str) -> str:
    """The same color for a name in every run (str.__hash__ changes
    with PYTHONHASHSEED from one interpreter to the next)."""
    return _COLORS[zlib.crc32(ref_name.encode()) % len(_COLORS)]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 2:
        print(__doc__)
        return 1
    paf, prefix = argv
    best = {}
    with open(paf) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 12:
                continue
            seg, ref = t[0], t[5]
            matches = int(t[9])
            ref_start = int(t[7])
            if seg not in best or matches > best[seg][2]:
                best[seg] = (ref, ref_start, matches)
    with open(prefix + "-labels.csv", "w") as f:
        f.write("Segment,Label\n")
        for seg, (ref, start, _m) in sorted(best.items()):
            f.write(f"{seg},{ref}:{start}\n")
    with open(prefix + "-colors.csv", "w") as f:
        f.write("Segment,Color\n")
        for seg, (ref, _start, _m) in sorted(best.items()):
            f.write(f"{seg},{color_of(ref)}\n")
    print(f"{len(best)} segments labeled. Wrote {prefix}-labels.csv, "
          f"{prefix}-colors.csv")
    return 0


if __name__ == "__main__":
    sys.exit(main())
