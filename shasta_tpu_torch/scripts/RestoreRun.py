#!/usr/bin/env python
"""Restore Data/ from DataOnDisk/ (reference: scripts/RestoreRun.py)."""
import os, shutil, sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    run_dir = argv[0] if argv else "."
    src = os.path.join(run_dir, "DataOnDisk")
    dst = os.path.join(run_dir, "Data")
    if os.path.islink(dst):
        os.unlink(dst)
    shutil.copytree(src, dst, dirs_exist_ok=True)
    print(f"Restored {dst} from {src}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
