#!/usr/bin/env python
"""Re-run frequency-filtered (method 1) marker k-mer selection
(reference: scripts/SelectKmersBasedOnFrequency.py).

Usage: SelectKmersBasedOnFrequency.py <runDir>
"""
import sys

from _common import open_run
from shasta_tpu_torch.data.kmers import select_kmers_frequency


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ck = a.config.kmers
    a.kmer_table = select_kmers_frequency(
        a.reads, ck.k, ck.probability, seed=ck.seed
    )
    a.store.save_stage("Kmers", a.kmer_table.arrays())
    print(f"Selected {a.kmer_table.marker_count} marker k-mers by "
          "global frequency (method 1).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
