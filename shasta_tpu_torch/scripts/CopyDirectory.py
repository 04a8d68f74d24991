#!/usr/bin/env python
"""Copy all files of a directory into a run's stage-store directory
(reference: scripts/CopyDirectory.py).

Usage: CopyDirectory.py <sourceDir> <runDir>
"""
import os
import shutil
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 2:
        print(__doc__)
        return 1
    src_dir, run_dir = argv[0], argv[1]
    dst_dir = os.path.join(run_dir, "Data")
    os.makedirs(dst_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(src_dir)):
        src = os.path.join(src_dir, name)
        if os.path.isfile(src):
            shutil.copy2(src, os.path.join(dst_dir, name))
            n += 1
    print(f"Copied {n} files from {src_dir} to {dst_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
