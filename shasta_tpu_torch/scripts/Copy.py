#!/usr/bin/env python
"""Copy a file into a run's stage-store directory
(reference: scripts/Copy.py — there a page-aligned copy onto the
huge-page filesystem; the stage store here is plain files, so this is
a plain copy with a destination check).

Usage: Copy.py <source> <runDir>
"""
import os
import shutil
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 2:
        print(__doc__)
        return 1
    src, run_dir = argv[0], argv[1]
    dst = os.path.join(run_dir, "Data", os.path.basename(src))
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copy2(src, dst)
    print(f"Copied {src} -> {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
