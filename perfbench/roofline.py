"""The DP kernels' least time: a frozen copy of the program's roofline
arithmetic, with the card's peaks.

Copies, kept here so that a change to the program cannot move the
yardstick:

- ``in_matrix_cells``: ``shasta_tpu_torch/ops/align_kernel.py:in_matrix_cells``;
- ``fwd_work`` and ``bound_ms``: ``chip_smoke.py:fwd_work`` and ``:bound_ms``;
- ``issue_limit_ops``: ``shasta_tpu_torch/utils/peak.py:issue_limit_ops``;
- ``FWD_INT_OPS_PER_CELL``: ``align_kernel.FWD_INT_OPS_PER_CELL``;
- ``tb_work`` and ``TB_OPS_PER_ROW``: the traceback's work in
  ``chip_smoke.py:kernel_classes`` and ``chip_smoke.TB_OPS_PER_ROW``.

A forward launch of B pairs needs, on every band cell of a processed row
that lies inside the matrix (0 <= j <= b_len), 13 int32 operations; and
it reads its inputs once and writes every 2-bit dirs word of a processed
row once. Its least time is the larger of the operations at the issue
limit (one warp instruction a cycle on each of an SM's 4 sub-partitions,
128 lanes an SM, at the card's highest SM clock) and the bytes at the
HBM rate. A traceback launch walks one row of each pair per step, from
its best row up: 12 int32 operations and one dirs word read a walked
row, and it reads its best rows and lanes and writes each pair's
(LA,) matched columns once.
"""

from __future__ import annotations

import torch

# Published peaks of one NVIDIA H100 SXM (data sheet): HBM3 bandwidth.
HBM_BYTES_PER_S = 3.35e12
# The H100 SXM's highest SM clock (MHz), where nvidia-smi cannot say.
H100_MAX_SM_MHZ = 1980.0
# Thread instructions one Hopper SM issues a cycle (4 sub-partitions x 32).
ISSUE_LANES_PER_SM = 128
# int32 operations the forward DP needs on an in-matrix band cell.
FWD_INT_OPS_PER_CELL = 13
# int32 operations the traceback needs on a walked row.
TB_OPS_PER_ROW = 12


def issue_limit_ops(sm_clock_mhz: float, sms: int) -> float:
    """Thread instructions per second at the issue limit."""
    return sms * ISSUE_LANES_PER_SM * sm_clock_mhz * 1e6


def in_matrix_cells(a_len, b_len, band_min, *, LA, W, chunk=1 << 22) -> int:
    """Band cells of processed rows inside the matrix (0 <= j <= b_len),
    the band of row i being j - i in [band_min, band_min + W); rows
    1..a_len are processed. Summed over row blocks of <= ``chunk`` cells."""
    rows = max(1, chunk // max(1, a_len.shape[0]))
    total = 0
    i64 = torch.int64
    for r in range(0, LA, rows):
        i = torch.arange(r + 1, min(LA, r + rows) + 1, dtype=i64, device=a_len.device)[None, :]
        r0 = band_min.to(i64)[:, None] + i
        lo = torch.clamp(r0, min=0)
        hi = torch.minimum(b_len.to(i64)[:, None], r0 + W - 1)
        n = torch.clamp(hi - lo + 1, min=0)
        total += int(torch.where(i <= a_len.to(i64)[:, None], n, 0).sum())
    return total


def fwd_work(a_len, b_len, band_min, LA, LB, W):
    """(in-matrix cells, nominal cells, bytes) of one forward launch on
    its clamped inputs."""
    B = a_len.shape[0]
    rows = a_len.clamp(max=LA).to(torch.int64)
    words = int(((rows + 15) // 16).sum()) * W
    cells = in_matrix_cells(a_len, b_len, band_min, LA=LA, W=W)
    return cells, int(rows.sum()) * W, 4 * B * (LA + LB) + 4 * 5 * B + 4 * words


def bound_ms(ops, nbytes, sm_clock_mhz, sms):
    """(least ms, what bounds it): ``ops`` at the issue limit or
    ``nbytes`` at the HBM rate, whichever takes longer."""
    t_ops = ops / issue_limit_ops(sm_clock_mhz, sms) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tb_work(bi, LA):
    """(walked rows, bytes) of one traceback launch; ``bi`` is each
    pair's best row, where its walk starts."""
    B = bi.shape[0]
    walked = int(bi.to(torch.int64).sum())
    return walked, 4 * B * LA + 4 * walked + 16 * B


def launch_bound_ms(name, work, LA, W, B, sm_clock_mhz, sms) -> float:
    """The least ms of one traced DP launch; ``name`` and ``work`` as the
    program's launch trace records them: a forward launch's
    (a_len, b_len, band_min, LB), a traceback's (bi,)."""
    if name == "banded_tb":
        walked, nbytes = tb_work(work[0], LA)
        return bound_ms(walked * TB_OPS_PER_ROW, nbytes, sm_clock_mhz, sms)[0]
    a_len, b_len, band_min, LB = work
    cells, _nominal, nbytes = fwd_work(a_len, b_len, band_min, LA, LB, W)
    return bound_ms(cells * FWD_INT_OPS_PER_CELL, nbytes, sm_clock_mhz, sms)[0]
