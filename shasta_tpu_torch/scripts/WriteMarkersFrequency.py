#!/usr/bin/env python
"""Write the frequency of every marker k-mer to CSV
(reference: scripts/WriteMarkersFrequency.py).

Usage: WriteMarkersFrequency.py <runDir> [output.csv]
"""
import os
import sys

import numpy as np

from _common import open_run
from shasta_tpu_torch.data import bases as B


def kmer_str(kmer_id: int, k: int) -> str:
    codes = [(kmer_id >> (2 * (k - 1 - i))) & 3 for i in range(k)]
    return B.decode_to_str(np.array(codes, np.uint8))


def main(argv=None) -> int:
    a, args = open_run(argv)
    out = args[1] if len(args) > 1 else os.path.join(a.run_dir, "MarkersFrequency.csv")
    k = a.markers.k
    counts = np.bincount(a.markers.kmer_ids, minlength=4 ** k)
    nz = np.flatnonzero(counts)
    order = nz[np.argsort(counts[nz])[::-1]]
    with open(out, "w") as f:
        f.write("KmerId,Kmer,Frequency\n")
        for kid in order:
            f.write(f"{kid},{kmer_str(int(kid), k)},{counts[kid]}\n")
    print(f"Wrote {order.shape[0]} marker k-mer frequencies to {out}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
