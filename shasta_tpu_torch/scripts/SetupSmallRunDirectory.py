#!/usr/bin/env python
"""Set up a run directory for a small run
(reference: scripts/SetupSmallRunDirectory.py — there the point was
plain files instead of the huge-page filesystem; the stage store here
always uses plain files, so this just prepares the directory and
symlinks the inputs).

Usage: SetupSmallRunDirectory.py <runDir> <input.fasta> [...]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 2:
        print(__doc__)
        return 1
    run_dir = argv[0]
    os.makedirs(run_dir, exist_ok=True)
    for src in argv[1:]:
        dst = os.path.join(run_dir, os.path.basename(src))
        if not os.path.exists(dst):
            os.symlink(os.path.abspath(src), dst)
        print(f"Linked {src} -> {dst}")
    print(f"Run directory {run_dir} ready.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
