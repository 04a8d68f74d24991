#!/usr/bin/env python
"""Convert every .fastq/.fastq.gz in a directory to .fasta
(reference: scripts/FastqToFastaAll.py).

Usage: FastqToFastaAll.py [directory]
"""
import gzip
import os
import sys


def convert(path_in, path_out):
    opener = gzip.open if path_in.endswith(".gz") else open
    n = 0
    with opener(path_in, "rt") as fin, open(path_out, "w") as fout:
        while True:
            header = fin.readline()
            if not header:
                break
            seq = fin.readline().rstrip()
            fin.readline()
            fin.readline()
            fout.write(f">{header[1:].rstrip()}\n{seq}\n")
            n += 1
    return n


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    d = argv[0] if argv else "."
    for name in sorted(os.listdir(d)):
        if name.endswith(".fastq") or name.endswith(".fastq.gz"):
            stem = name[: -len(".fastq.gz")] if name.endswith(".gz") \
                else name[: -len(".fastq")]
            out = os.path.join(d, stem + ".fasta")
            n = convert(os.path.join(d, name), out)
            print(f"{name} -> {stem}.fasta ({n} reads)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
