#!/usr/bin/env python
"""Copy Data/ to DataOnDisk/ (reference: scripts/SaveRun.py)."""
import os, shutil, sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    run_dir = argv[0] if argv else "."
    src = os.path.join(run_dir, "Data")
    dst = os.path.join(run_dir, "DataOnDisk")
    shutil.copytree(src, dst, dirs_exist_ok=True)
    print(f"Saved {src} -> {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
