#!/usr/bin/env python
"""Build the native support library (reference: scripts/CreateModules.py,
which built the pybind11 modules; the native code here is a small C
ABI library built on demand)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from shasta_tpu_torch import native


def main(argv=None) -> int:
    lib = native.get_lib()
    if lib is None:
        print("Native library unavailable (no toolchain?); "
              "pure-Python fallbacks will be used.")
        return 1
    print(f"Native library built and loaded: {native.available()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
