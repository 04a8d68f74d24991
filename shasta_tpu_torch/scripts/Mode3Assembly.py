#!/usr/bin/env python
"""Run mode-3 assembly on a stored run (reference: scripts/Mode3Assembly.py)."""
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    print(a.assemble_mode3())
    return 0


if __name__ == "__main__":
    sys.exit(main())
