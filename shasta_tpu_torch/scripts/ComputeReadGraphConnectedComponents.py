#!/usr/bin/env python
"""Read graph connected components
(reference: scripts/ComputeReadGraphConnectedComponents.py)."""
import sys

import numpy as np

from _common import open_run
from shasta_tpu_torch.graph.read_graph import connected_components_excluding_cross


def main(argv=None) -> int:
    a, _ = open_run(argv)
    label = connected_components_excluding_cross(a.read_graph)
    _, sizes = np.unique(label, return_counts=True)
    sizes = np.sort(sizes)[::-1]
    print(f"{sizes.shape[0]} components; largest sizes: {sizes[:10].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
