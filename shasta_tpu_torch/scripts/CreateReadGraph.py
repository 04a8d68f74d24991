#!/usr/bin/env python
"""Re-run read graph creation (reference: scripts/CreateReadGraph.py)."""
import sys
from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.create_read_graph()
    print(f"Read graph: {a.read_graph.edge_count} edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
