#!/usr/bin/env python
"""Run sequence assembly on the stored marker/assembly graph and write
Assembly.{fasta,gfa} (reference: scripts/Assemble.py)."""
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.assemble_mode0()
    summary = a.write_output()
    print(
        f"{summary.get('assembledSegmentCount', 0)} segments, "
        f"N50 {summary.get('assembledSegmentN50', 0)}."
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
