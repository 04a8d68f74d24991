#!/usr/bin/env python
"""Re-run the mode-0 assembly stages + writers
(reference: scripts/RunAssembly-style drivers)."""
import sys
from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.assemble_mode0()
    summary = a.write_output()
    print(f"Assembled {summary['assembledSegmentCount']} segments, "
          f"N50 {summary['assembledSegmentN50']}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
