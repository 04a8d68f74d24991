#!/usr/bin/env python
"""Look up a read id by name (reference: scripts/GetReadId.py).

Usage: GetReadId.py <runDir> <readName>
"""
import sys

from _common import open_run


def main(argv=None) -> int:
    a, args = open_run(argv)
    name = args[1]
    try:
        print(a.reads.names.index(name))
    except ValueError:
        print(f"Read {name!r} not found.", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
