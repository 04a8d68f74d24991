#!/usr/bin/env python
"""Built-in self-test (reference: scripts/Test.py)."""
import sys
import tempfile

from _common import take_device
from shasta_tpu_torch.pipeline.assemble import Assembler


def main(argv=None) -> int:
    device, _ = take_device(argv)
    with tempfile.TemporaryDirectory() as d:
        ok = Assembler(d, device=device).test()
    print("Self-test passed." if ok else "Self-test FAILED.")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
