#!/usr/bin/env python
"""Run mode-2 (phased diploid) assembly stages on a stored run
(reference: scripts/Mode2Assembly-A.py / -B.py)."""
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.config.assembly.mode = 2
    print(a.assemble_mode2())
    return 0


if __name__ == "__main__":
    sys.exit(main())
