#!/usr/bin/env python
"""Remove the Data stage directory from a run
(reference: scripts/CleanupRunDirectory.py).

Usage: CleanupRunDirectory.py <runDir>
"""
import os
import shutil
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    run_dir = argv[0] if argv else "."
    data = os.path.join(run_dir, "Data")
    if os.path.islink(data):
        os.unlink(data)
    elif os.path.isdir(data):
        shutil.rmtree(data)
    else:
        print(f"No Data directory in {run_dir}.")
        return 1
    print(f"Removed {data}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
