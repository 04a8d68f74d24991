#!/usr/bin/env python
"""Set the removal flags of all marker graph edges to specified
values; pass 2 to leave a flag unchanged
(reference: scripts/SetMarkerGraphEdgeFlags.py)."""
import argparse
import sys

from _common import DEVICE_HELP, attach


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Set marker graph edge flags (2 = leave unchanged)."
    )
    parser.add_argument("runDir", nargs="?", default=".")
    parser.add_argument("--wasRemovedByTransitiveReduction", type=int, default=2,
                        choices=range(3))
    parser.add_argument("--wasPruned", type=int, default=2, choices=range(3))
    parser.add_argument("--isSuperBubbleEdge", type=int, default=2, choices=range(3))
    parser.add_argument("--isLowCoverageCrossEdge", type=int, default=2,
                        choices=range(3))
    parser.add_argument("--wasAssembled", type=int, default=2, choices=range(3))
    parser.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = parser.parse_args(argv)

    a = attach(args.runDir, args.device)
    mg = a.marker_graph
    flags = {
        "removed_tr": args.wasRemovedByTransitiveReduction,
        "pruned": args.wasPruned,
        "superbubble": args.isSuperBubbleEdge,
        "low_coverage_cross": args.isLowCoverageCrossEdge,
        "was_assembled": args.wasAssembled,
    }
    for name, value in flags.items():
        if value == 2:
            continue
        arr = getattr(mg, name, None)
        if arr is None:
            print(f"Flag {name} not present; skipped.")
            continue
        arr[:] = bool(value)
        print(f"Set {name} = {value} on {arr.shape[0]} edges.")
    a.store.save_stage("MarkerGraph", mg.arrays())
    return 0


if __name__ == "__main__":
    sys.exit(main())
