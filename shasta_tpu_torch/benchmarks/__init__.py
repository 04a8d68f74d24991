"""The JAX system's scale and A/B scripts (``benchmarks/``), ported.

Each module runs as ``python -m shasta_tpu_torch.benchmarks.<name>``,
keeps its script's environment knobs, seeds, defaults and output, and
adds ``--device`` (``cuda`` by default; without a card it raises, and
nothing falls back to the CPU). Importing a module runs nothing: its body
is ``main(argv=None) -> int``.

- ``scale_bench``: mode 0 at ``SCALE`` Mb, graded against the genome.
- ``mode2_scale_bench``: mode 2 on a ``SCALE`` Mb diploid genome.
- ``waves_ab``: the DP at waves 1, 2 and 4 at the bench's roofline shape.
- ``mode2_phase_exp``: four phasing thresholds on a 2 Mb diploid genome.
"""

from __future__ import annotations

import argparse


def parse_device(prog: str, description: str, argv=None) -> str:
    """The modules' one option, ``--device`` (default ``cuda``), checked
    by ``align_kernel.resolve_device``: a missing card raises here,
    before any work."""
    from shasta_tpu_torch.ops.align_kernel import resolve_device

    p = argparse.ArgumentParser(prog=f"python -m shasta_tpu_torch.benchmarks.{prog}",
                                description=description)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    resolve_device(args.device)
    return args.device
