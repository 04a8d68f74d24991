#!/usr/bin/env python
"""Create the assembly graph and assemble sequence from a stored
marker graph, writing the final outputs
(reference: scripts/CreateAssembly.py)."""
import json
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.assemble_mode0()
    summary = a.write_output()
    print(json.dumps(
        {k: v for k, v in summary.items() if not isinstance(v, dict)}, indent=1
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
