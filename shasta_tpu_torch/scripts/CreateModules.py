#!/usr/bin/env python
"""Build the native support library (reference: scripts/CreateModules.py,
which built the pybind11 modules; the native code here is a small C
ABI library built on demand)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from shasta_tpu_torch import native


def main(argv=None) -> int:
    native.get_lib()  # raises RuntimeError with g++'s output on failure
    # The JAX package's script prints whether its library loaded.
    print("Native library built and loaded: True")
    return 0


if __name__ == "__main__":
    sys.exit(main())
