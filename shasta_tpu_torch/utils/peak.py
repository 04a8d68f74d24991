"""The card's int32 elementwise ceiling: a CUDA kernel and its plain version.

Counterpart of ``bench.py:vpu_peak_prepare`` (bench.py:143), whose chain
of eight dependent int32 operations per element per iteration
(bench.py:164-177) XLA fuses into one loop. ``int32_chain`` runs that
chain on the card as the hand-written kernel ``csrc/int32_peak.cu``,
which keeps it in registers; ``int32_chain_plain`` is the same chain as
torch ops, eight per iteration. The wrapper runs the plain version only
because its tensor lies on the CPU; on a CUDA tensor it launches the
kernel or raises.

The adds wrap modulo 2**32, as XLA's int32 adds do, so the kernel, the
plain version and the JAX chain agree modulo 2**32.
"""

from __future__ import annotations

import subprocess

import torch

from shasta_tpu_torch.ops import align_kernel as AK

# Launches of the kernel (a plain integer; the bench prints it).
LAUNCHES = {"int32_chain": 0}

# The source operations of one iteration, the count bench.py's ops/s
# uses (the compiler may fuse some: chip_smoke.py phase 1 counts the
# loop's SASS and checks that it issues no fewer).
OPS_PER_ITERATION = 8
# The data sheet's int32 lanes per Hopper SM (4 partitions x 16 INT32
# units); the card's int32 rate by the data sheet is this times the SMs
# and the SM clock. An H100 runs bench.py's chain faster than that (an
# IMAD issues on the FMA pipe), so this rate bounds no kernel's time.
INT32_LANES_PER_SM = 64
# The issue limit of a Hopper SM: one warp instruction a cycle on each
# of its 4 sub-partitions. No kernel issues instructions faster, so
# operations counted no higher than the instructions a kernel issues,
# over this rate at the SM's highest clock, bound its time from below.
ISSUE_LANES_PER_SM = 128
_XOR = -1640531527  # 0x9E3779B9 as int32
_MIN = 1 << 30


def nvidia_smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` for the
    first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def data_sheet_int32_ops(sm_clock_mhz: float, sms: int) -> float:
    """int32 operations per second by the data sheet: INT32_LANES_PER_SM
    lanes on each of ``sms`` SMs at ``sm_clock_mhz``."""
    return sms * INT32_LANES_PER_SM * sm_clock_mhz * 1e6


def issue_limit_ops(sm_clock_mhz: float, sms: int) -> float:
    """Thread instructions per second at the issue limit:
    ISSUE_LANES_PER_SM lanes on each of ``sms`` SMs at ``sm_clock_mhz``."""
    return sms * ISSUE_LANES_PER_SM * sm_clock_mhz * 1e6


def int32_chain_plain(x: torch.Tensor, K: int) -> torch.Tensor:
    """bench.py's chain as torch ops on any device: K iterations i of
    y + i, ^ 0x9E3779B9, max(., i), y + y, ^ i, min(., 2**30), + 13,
    ^ (i + 1), in int32 (adds wrap)."""
    y = x.to(torch.int32).clone()
    for i in range(K):
        y = y + i
        y = y ^ _XOR
        y = torch.clamp(y, min=i)
        y = y + y
        y = y ^ i
        y = torch.clamp(y, max=_MIN)
        y = y + 13
        y = y ^ (i + 1)
    return y


def int32_chain(x: torch.Tensor, K: int) -> torch.Tensor:
    """The chain over every element of the int32 tile ``x``, K
    iterations; the tile after it. CPU tensors run the plain version;
    CUDA tensors launch csrc/int32_peak.cu."""
    if x.device.type != "cuda":
        return int32_chain_plain(x, K)
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("int32_chain takes a contiguous int32 tensor")
    if K < 0 or x.numel() >= 2**31:
        raise ValueError(f"int32_chain: K >= 0 and fewer than 2**31 elements; got K={K}, "
                         f"{x.numel()} elements")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = AK.library()
    rc = lib.int32_chain_launch(
        x.data_ptr(), x.numel(), K, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"int32_chain launch failed (cudaError {rc}) at {x.numel()} x K {K}")
    LAUNCHES["int32_chain"] += 1
    return out
