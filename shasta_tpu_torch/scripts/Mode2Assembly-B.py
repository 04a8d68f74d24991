#!/usr/bin/env python
"""Run the final portion of mode-2 assembly: the AssemblyGraph2
pipeline through the Detailed/Haploid/Phased output family
(reference: scripts/Mode2Assembly-B.py)."""
import json
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.config.assembly.mode = 2
    stats = a.assemble_mode2()
    print(json.dumps(stats, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
