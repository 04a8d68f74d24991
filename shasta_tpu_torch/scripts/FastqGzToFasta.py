#!/usr/bin/env python
"""Convert a gzipped FASTQ to FASTA
(reference: scripts/FastqGzToFasta.py).

Usage: FastqGzToFasta.py input.fastq.gz output.fasta
"""
import gzip
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 2:
        print(__doc__)
        return 2
    with gzip.open(argv[0], "rt") as fin, open(argv[1], "w") as fout:
        n = 0
        while True:
            header = fin.readline()
            if not header:
                break
            seq = fin.readline().rstrip()
            fin.readline()  # +
            fin.readline()  # qualities
            fout.write(f">{header[1:].rstrip()}\n{seq}\n")
            n += 1
    print(f"Converted {n} reads.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
