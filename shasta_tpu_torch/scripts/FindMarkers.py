#!/usr/bin/env python
"""Re-run marker finding on a stored run
(reference: scripts/FindMarkers.py)."""
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.find_markers()
    print(f"Found {a.markers.total_count} markers over "
          f"{a.markers.oriented_read_count} oriented reads.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
