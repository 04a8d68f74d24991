#!/usr/bin/env python
"""Print the effective configuration of a stored run
(reference: scripts/GetConfig.py).

Usage: GetConfig.py <runDir>
"""
import os
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    run_dir = argv[0] if argv else "."
    path = os.path.join(run_dir, "shasta.conf")
    with open(path) as f:
        sys.stdout.write(f.read())
    return 0


if __name__ == "__main__":
    sys.exit(main())
