#!/usr/bin/env python
"""Convert FASTQ (possibly .gz) to FASTA
(reference: scripts/FastqToFasta.py, FastqGzToFasta.py).

Usage: FastqToFasta.py input.fastq[.gz] output.fasta
"""
import gzip
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    inp, outp = argv[0], argv[1]
    op = gzip.open if inp.endswith(".gz") else open
    with op(inp, "rt") as f, open(outp, "w") as g:
        i = 0
        for line in f:
            m = i % 4
            if m == 0:
                g.write(">" + line[1:])
            elif m == 1:
                g.write(line)
            i += 1
    print(f"Converted {i // 4} reads.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
