#!/usr/bin/env python
"""Warm the OS page cache with all stage data Mode2Assembly-B needs
(reference: scripts/Mode2Assembly-B-Prepare.py, which streamed the
Data/ binaries to /dev/null for the same reason)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    run_dir = argv[0] if argv else "."
    total = 0
    n = 0
    for root, _dirs, files in os.walk(run_dir):
        for name in files:
            if not (name.endswith(".npy") or name.endswith(".npz")):
                continue
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                while True:
                    chunk = f.read(1 << 22)
                    if not chunk:
                        break
                    total += len(chunk)
            n += 1
    print(f"Read {n} stage files ({total / 1e6:.1f} MB) into the page cache.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
