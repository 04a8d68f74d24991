#!/usr/bin/env python
"""Re-run random (method 0) marker k-mer selection on a stored run
(reference: scripts/RandomlySelectKmers.py).

Usage: RandomlySelectKmers.py <runDir> [k] [probability] [seed]
"""
import sys

from _common import open_run
from shasta_tpu_torch.data.kmers import select_kmers_random


def main(argv=None) -> int:
    a, args = open_run(argv)
    k = int(args[1]) if len(args) > 1 else a.config.kmers.k
    p = float(args[2]) if len(args) > 2 else a.config.kmers.probability
    seed = int(args[3]) if len(args) > 3 else 231
    a.kmer_table = select_kmers_random(k, p, seed=seed)
    a.store.save_stage("Kmers", a.kmer_table.arrays())
    print(f"Selected {a.kmer_table.marker_count} marker k-mers "
          f"(k={k}, probability={p}).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
