"""The forward DP at 1, 2 and 4 pairs per warp on the card: ``banded_fwd``
(waves 1) against ``banded_fwd_waves`` (waves 2 and 4) at the bench's
roofline shape (B 1024, LA = LB = 512, W 128). The port of the JAX
system's ``benchmarks/waves_ab.py``.

    [WAVES_AB_REPS=6] python -m shasta_tpu_torch.benchmarks.waves_ab [--device cuda|cpu]

Each variant is ``bench.kernel_roofline_prepare(waves=)``: chains of
``banded_align_pairs`` timed by CUDA graph replays, K 26 against K 2.
The reps of the three variants interleave, ``WAVES_AB_REPS`` rounds of
them. It raises unless every variant's chain gives the waves-1 chain's
output. Prints a line per rep, then one JSON line: the best Gcells/s of
each variant (``waves{1,2,4}_gcells_per_sec``) and ``speedup_w2`` and
``speedup_w4``, the best rates over waves 1's.

``--device cpu`` runs the plain PyTorch version at the full shape (slow);
tests shrink it by monkeypatching ``bench.roofline_batch``.
"""

from __future__ import annotations

import json
import os
import sys

VARIANTS = (1, 2, 4)


def main(argv=None) -> int:
    import torch

    from shasta_tpu_torch import bench
    from shasta_tpu_torch.benchmarks import parse_device

    device = torch.device(parse_device(
        "waves_ab", "The forward DP at waves 1, 2 and 4 at the bench's roofline shape.", argv))
    reps, first = {}, {}
    for w in VARIANTS:
        print(f"[waves_ab] preparing waves={w}", flush=True)
        reps[w], _eager, first[w] = bench.kernel_roofline_prepare(device, waves=w)
    if any(first[w] != first[1] for w in VARIANTS):
        raise RuntimeError(f"the variants' chains disagree with waves 1's: {first}")

    best = {w: 0.0 for w in VARIANTS}
    n = int(os.environ.get("WAVES_AB_REPS", "6"))
    for r in range(n):
        for w in VARIANTS:
            g, _ = reps[w]()
            best[w] = max(best[w], g)
            print(f"[waves_ab] rep {r} waves={w}: {g:.2f} Gcells/s", flush=True)

    out = {f"waves{w}_gcells_per_sec": round(best[w], 2) for w in VARIANTS}
    out["speedup_w2"] = round(best[2] / best[1], 3) if best[1] else 0.0
    out["speedup_w4"] = round(best[4] / best[1], 3) if best[1] else 0.0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
