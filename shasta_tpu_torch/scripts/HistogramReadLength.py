#!/usr/bin/env python
"""Read length histogram (reference: scripts/HistogramReadLength.py)."""
import sys

import numpy as np

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    lengths = a.reads.raw_lengths
    hist = np.bincount(lengths // 1000)
    print("LengthKb,Frequency")
    for i, c in enumerate(hist):
        if c:
            print(f"{i},{c}")
    print(f"Total {lengths.shape[0]} reads, {int(lengths.sum())} bases, "
          f"N50 {int(np.sort(lengths)[np.searchsorted(np.cumsum(np.sort(lengths)), lengths.sum() / 2)])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
