"""Batched banded marker alignment: CUDA kernels and their plain version.

Counterpart of ``shasta_tpu/ops/align_pallas.py``. Two hand-written CUDA
kernels (``csrc/banded_align.cu``) replace the three Pallas kernels on
the main path:

- ``banded_fwd`` replaces ``_kernel``'s forward half
  (align_pallas.py:156) and ``_fwd_chunked_kernel`` (:581);
- ``banded_tb`` replaces ``_kernel``'s traceback half (:296-337) and
  ``_tb_chunked_kernel`` (:714).

The TPU splits monolithic and chunked regimes because of its VMEM
budget; the card has no such budget, so one kernel pair serves every
LA and every W up to 16384 (a wider band raises). The forward kernel writes the 2-bit direction codes (16 rows to
an int32 word) to device memory; the traceback kernel walks them back.

Contract (the JAX wrapper's, align_pallas.py:948-1017):

- ``a`` (B, LA) int32 padded with -1; ``b`` (B, LB) int32 padded with
  -2; lengths and ``band_min`` (B,) int32. The band of row i is
  j - i in [band_min, band_min + W).
- ``band_min`` is clamped to [-(LA + W), LB] and pairs whose band lies
  outside the matrix are emptied (a_len = 0) before either version runs.
- int32 scores, linear gaps, ``NEG_INF = -2**30``; free start on row 0
  and at j == 0, free end on the last row or the last column.
- Best end: max score, then earliest row, then last column before last
  row, then lowest lane.

``banded_align_pairs`` returns the fused (B, 16 + LA) int32 layout: the
16 metric columns of ``_metrics_from_mj`` (align_pallas.py:876), then the
matched ordinal1 per ordinal0 (or -1).

A wrapper runs the plain PyTorch version only because its tensors lie on
the CPU; on CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

NEG_INF = -(2**30)
BIG = 1 << 29
# Direction codes as stored (2 bits): DIAG with a k-mer match, DIAG
# without, UP, LEFT. The j == 0 terminal is recomputed at traceback.
D_MATCH, D_MISMATCH, UP, LEFT = 0, 1, 2, 3

# Launches of each CUDA kernel (plain integers; chip_smoke.py resets and
# reads them to show the main path ran on the kernels).
LAUNCHES = {"banded_fwd": 0, "banded_tb": 0}

# Optional launch trace: when a caller sets this to a list, every CUDA
# launch appends (name, LA, W, B, a_len, start, end) with CUDA events
# recorded around it on the current stream (a_len: the clamped device
# lengths, for the cells a launch really processes). None: no events.
TRACE = None

# int32 operations the forward DP needs on an interior band cell (the
# bound's count): match compare and select 2, diag and up adds 2, their
# max 1, the scan subtract 1, running max 1, the max with the carried-in
# prefix 1, the add-back 1, the direction code (two compares, three
# selects) 5, the 2-bit pack (shift, or) 2, one validity mask 1. The
# end-cell accumulation and the j == 0 clamp touch O(LA + W) cells of a
# pair and are left out, as are the per-row lane-range tests, which a
# kernel can work out once per row.
FWD_INT_OPS_PER_CELL = 17
# What banded_fwd_kernel's per-lane row body issues as written: index
# and band tests 7, b load and compare 3, diag/up/base 5, j == 0 clamp 2,
# run and local prefix max 3, the scan's share per lane ~1, V and mask
# 3, direction select 4, end-cell accumulation 7, 2-bit pack 2.
FWD_INT_OPS_PER_CELL_ISSUED = 37

# Byte budget of the packed dirs of one forward launch.
_DIRS_BYTES = 1 << 30
# The widest band the forward kernel takes (banded_fwd_launch's limit).
MAX_W = 16384

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "banded_align.cu",
)
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "cuda",
)
_SO = os.path.join(_BUILD_DIR, "libbanded_align.so")

_lib = None
_lock = threading.Lock()


# ---------------------------------------------------------------------------
# Build and load (first use, never at import)
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_kernels(force: bool = False) -> float:
    """Compile csrc/banded_align.cu for sm_90a into the git-ignored
    build directory and load it. Returns the build seconds (0 when the
    library was already built from the current source)."""
    global _lib
    with _lock:
        t0 = time.perf_counter()
        stale = not os.path.exists(_SO) or (
            os.path.getmtime(_SO) < os.path.getmtime(_CSRC)
        )
        if force or stale:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{_SO}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [
                    _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", tmp, _CSRC,
                ],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, _SO)
            _lib = None
        if _lib is None:
            lib = ctypes.CDLL(_SO)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.banded_fwd_launch.argtypes = [
                vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                vp, vp, vp, vp, vp,
            ]
            lib.banded_fwd_launch.restype = ci
            lib.banded_tb_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp]
            lib.banded_tb_launch.restype = ci
            _lib = lib
        return time.perf_counter() - t0


def _load():
    if _lib is None:
        build_kernels()
    return _lib


def _check_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one device")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous int32")


def _trace_start():
    if TRACE is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _trace_end(start, name, LA, W, B, rows) -> None:
    if start is None:
        return
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    TRACE.append((name, LA, W, B, rows, start, end))


# ---------------------------------------------------------------------------
# The two kernels' wrappers (CUDA tensors) and their plain versions
# ---------------------------------------------------------------------------


def n_words(LA: int) -> int:
    """Packed dirs words per lane: 16 rows of 2-bit codes per int32."""
    return (LA + 15) // 16


def banded_fwd(a, a_len, b, b_len, band_min, *, LA, LB, W, match, mismatch, gap):
    """Forward DP on prepared (clamped) inputs. Returns
    (dirs (B, ceil(LA/16), W) int32, best, bi, bd (B,) int32). Rows
    beyond a pair's a_len are not written (the traceback never reads
    them)."""
    if a.device.type != "cuda":
        return banded_fwd_plain(
            a, a_len, b, b_len, band_min,
            LA=LA, LB=LB, W=W, match=match, mismatch=mismatch, gap=gap,
        )
    _check_cuda(a, a_len, b, b_len, band_min)
    if W > MAX_W:
        raise ValueError(
            f"banded_fwd takes W <= {MAX_W} (two rows in shared memory); got {W}"
        )
    B = a.shape[0]
    dev = a.device
    dirs = torch.empty((B, n_words(LA), W), dtype=torch.int32, device=dev)
    best = torch.empty(B, dtype=torch.int32, device=dev)
    bi = torch.empty(B, dtype=torch.int32, device=dev)
    bd = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return dirs, best, bi, bd
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ev = _trace_start()
    rc = lib.banded_fwd_launch(
        a.data_ptr(), b.data_ptr(), a_len.data_ptr(), b_len.data_ptr(),
        band_min.data_ptr(), B, LA, LB, W, match, mismatch, gap,
        dirs.data_ptr(), best.data_ptr(), bi.data_ptr(), bd.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"banded_fwd launch failed (cudaError {rc}) at "
            f"B={B} LA={LA} LB={LB} W={W}"
        )
    LAUNCHES["banded_fwd"] += 1
    _trace_end(ev, "banded_fwd", LA, W, B, a_len)
    return dirs, best, bi, bd


def banded_tb(dirs, bi, bd, band_min, *, LA, W):
    """Traceback over the packed dirs. Returns mj (B, LA) int32: the
    matched ordinal1 for each ordinal0, or -1."""
    if dirs.device.type != "cuda":
        return banded_tb_plain(dirs, bi, bd, band_min, LA=LA, W=W)
    _check_cuda(dirs, bi, bd, band_min)
    B = dirs.shape[0]
    mj = torch.empty((B, LA), dtype=torch.int32, device=dirs.device)
    if B == 0:
        return mj
    lib = _load()
    stream = torch.cuda.current_stream(dirs.device).cuda_stream
    ev = _trace_start()
    rc = lib.banded_tb_launch(
        dirs.data_ptr(), bi.data_ptr(), bd.data_ptr(), band_min.data_ptr(),
        B, LA, W, mj.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"banded_tb launch failed (cudaError {rc}) at B={B} LA={LA} W={W}"
        )
    LAUNCHES["banded_tb"] += 1
    _trace_end(ev, "banded_tb", LA, W, B, bi)
    return mj


def banded_fwd_plain(
    a, a_len, b, b_len, band_min, *, LA, LB, W, match, mismatch, gap
):
    """The forward DP as a row loop of int32 torch ops (the counterpart
    of shasta_tpu/ops/align.py:_banded_forward, with the Pallas
    kernel's packed 2-bit dirs layout and best-end accumulator). Codes
    of rows beyond a pair's a_len are 0, like the kernel's unwritten
    bits of a partly filled word."""
    B = a.shape[0]
    dev = a.device
    i32 = torch.int32
    d_idx = torch.arange(W, dtype=i32, device=dev)[None, :]
    dgap = d_idx * gap
    neg_col = torch.full((B, 1), NEG_INF, dtype=i32, device=dev)
    bm = band_min[:, None]
    bl = b_len[:, None]
    al = a_len[:, None]
    j0 = bm + d_idx
    prev = torch.where((j0 >= 0) & (j0 <= bl), 0, NEG_INF).to(i32)
    bv = torch.full((B, W), NEG_INF, dtype=i32, device=dev)
    bim = torch.zeros((B, W), dtype=i32, device=dev)
    words = torch.zeros((B, n_words(LA), W), dtype=torch.int64, device=dev)
    for i in range(1, LA + 1):
        j = bm + i + d_idx
        jm1 = j - 1
        inb = (jm1 >= 0) & (jm1 < LB)
        bj = torch.gather(b, 1, jm1.clamp(0, max(LB - 1, 0)).to(torch.int64))
        bj = torch.where(inb, bj, -2)
        m = bj == a[:, i - 1 : i]
        sub = torch.where(m, match, mismatch).to(i32)
        valid = (j >= 0) & (j <= bl) & (i <= al)
        at_j0 = j == 0
        prev_up = torch.cat([prev[:, 1:], neg_col], dim=1)
        diag = prev + sub
        base = torch.maximum(diag, prev_up + gap)
        base = torch.where(at_j0, torch.clamp(base, min=0), base)
        run = torch.cummax(base - dgap, dim=1).values.clamp(min=NEG_INF)
        V = torch.where(valid, run + dgap, NEG_INF).to(i32)
        code = torch.where(
            V > base, LEFT,
            torch.where(base == diag, torch.where(m, D_MATCH, D_MISMATCH), UP),
        )
        code = torch.where(al >= i, code, 0).to(torch.int64)
        words[:, (i - 1) // 16, :] |= code << (2 * ((i - 1) % 16))
        iscol = (j == bl) & valid
        endm = iscol | ((al == i) & valid)
        mv = torch.where(endm, V, NEG_INF)
        bt = mv > bv
        bv = torch.where(bt, mv, bv)
        bim = torch.where(bt, torch.where(iscol, 2 * i, 2 * i + 1), bim).to(i32)
        prev = V
    # Best end: max score, then min (2*row + not-column), then min lane.
    maxv = bv.max(dim=1, keepdim=True).values
    cand = bv == maxv
    mini = torch.where(cand, bim, BIG).min(dim=1, keepdim=True).values
    cand2 = cand & (bim == mini)
    bd = torch.where(cand2, d_idx, W).min(dim=1).values.to(i32)
    # Two's-complement wrap of the packed words into int32.
    dirs = torch.where(words >= 2**31, words - 2**32, words).to(i32)
    return dirs, maxv[:, 0].to(i32), (mini[:, 0] >> 1).to(i32), bd


def banded_tb_plain(dirs, bi, bd, band_min, *, LA, W):
    """The traceback as a row loop of int32 torch ops (the counterpart
    of _kernel's traceback, align_pallas.py:296-337): each row resolves
    at the greatest non-LEFT lane at or below the entry lane, with the
    j == 0 cell read as the terminal code 4."""
    B = dirs.shape[0]
    dev = dirs.device
    i32 = torch.int32
    d_idx = torch.arange(W, dtype=i32, device=dev)[None, :]
    d8 = d_idx * 8
    entry = torch.full((B, 1), -1, dtype=i32, device=dev)
    jb = (band_min + LA)[:, None].to(i32)
    bi = bi[:, None]
    bd = bd[:, None]
    mj = torch.empty((B, LA), dtype=i32, device=dev)
    for i in range(LA, 0, -1):
        entry = torch.where(bi == i, bd, entry)
        word = dirs[:, (i - 1) // 16, :]
        code = (word >> (2 * ((i - 1) % 16))) & 3
        adj = torch.where(jb + d_idx == 0, 4, code)
        elig = (d_idx <= entry) & (adj != LEFT)
        kmax = torch.where(elig, d8 + adj, -1).max(dim=1, keepdim=True).values
        exit_d = kmax >> 3
        acode = kmax & 7
        j_exit = jb + exit_d
        is_match = (acode == D_MATCH) & (j_exit > 0)
        mj[:, i - 1] = torch.where(is_match, j_exit - 1, -1)[:, 0]
        entry = torch.where(
            acode <= D_MISMATCH, exit_d, torch.where(acode == UP, exit_d + 1, -1)
        )
        entry = torch.where(entry >= W, -1, entry).to(i32)
        jb = jb - 1
    return mj


# ---------------------------------------------------------------------------
# Metrics and the public entry point
# ---------------------------------------------------------------------------


def metrics_from_mj(mj: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """AlignmentInfo metrics from the (B, LA) match matrix:
    [count, min_o0, max_o0, min_o1, max_o1, min_offset, max_offset,
    max_skip, max_drift, best_score, 0 x 6] (B, 16) int32.

    The previous match of each row is found with a cummax over row
    indices and a gather, not with the JAX package's packed
    ``(row << 16) | ordinal1`` key (align_pallas.py:897), which
    overflows int32 at rows >= 32768 and ordinals >= 65536."""
    B, LA = mj.shape
    dev = mj.device
    i32 = torch.int32
    valid = mj >= 0
    iota = torch.arange(LA, dtype=i32, device=dev)[None, :]
    count = valid.sum(dim=1, dtype=i32)

    def vmin(x):
        return torch.where(valid, x, BIG).min(dim=1).values

    def vmax(x):
        return torch.where(valid, x, -BIG).max(dim=1).values

    off = iota - mj
    last = torch.cummax(torch.where(valid, iota, -1), dim=1).values
    prow = torch.cat([torch.full((B, 1), -1, dtype=i32, device=dev), last[:, :-1]], 1)
    pv = valid & (prow >= 0)
    po1 = torch.gather(mj, 1, prow.clamp(min=0).to(torch.int64))
    skip = torch.where(pv, torch.maximum(iota - prow, (mj - po1).abs()), 0)
    drift = torch.where(pv, (off - (prow - po1)).abs(), 0)
    zero = torch.zeros_like(count)
    cols = [
        count, vmin(iota.expand(B, LA)), vmax(iota.expand(B, LA)),
        vmin(mj), vmax(mj), vmin(off), vmax(off),
        skip.max(dim=1).values if LA else zero,
        drift.max(dim=1).values if LA else zero,
        best.to(i32),
    ] + [zero] * 6
    return torch.stack([c.to(i32) for c in cols], dim=1)


def prepare_inputs(a, a_len, b, b_len, band_min, *, LA, LB, W):
    """int32 inputs with the wrapper's clamping (align_pallas.py:992-997):
    pairs whose band lies wholly outside the matrix get a_len = 0 and
    band_min is clamped to [-(LA + W), LB]."""
    i32 = torch.int32
    a = a.to(i32).contiguous()
    b = b.to(i32).contiguous()
    a_len = a_len.to(i32)
    b_len = b_len.to(i32).contiguous()
    band_min = band_min.to(i32)
    leftpad = LA + W
    ok = (band_min >= -leftpad) & (band_min <= LB)
    a_len = torch.where(ok, a_len, 0).to(i32).contiguous()
    band_min = band_min.clamp(-leftpad, LB).to(i32).contiguous()
    return a, a_len, b, b_len, band_min


def dirs_chunk_pairs(LA: int, W: int) -> int:
    """Pairs per launch under the dirs byte budget ``_DIRS_BYTES``."""
    return max(1, _DIRS_BYTES // (n_words(LA) * W * 4))


def banded_align_pairs(
    a, a_len, b, b_len, band_min, *, LA, LB, W, match, mismatch, gap
) -> torch.Tensor:
    """Forward + traceback for a batch of pairs; (B, 16 + LA) int32.

    CPU tensors run the plain version; CUDA tensors run the kernels,
    in launches of at most :func:`dirs_chunk_pairs` pairs each."""
    a, a_len, b, b_len, band_min = prepare_inputs(
        a, a_len, b, b_len, band_min, LA=LA, LB=LB, W=W
    )
    B = a.shape[0]
    kw = dict(LA=LA, LB=LB, W=W, match=match, mismatch=mismatch, gap=gap)
    step = dirs_chunk_pairs(LA, W)
    mjs, bests = [], []
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        dirs, best, bi, bd = banded_fwd(
            a[lo:hi], a_len[lo:hi], b[lo:hi], b_len[lo:hi], band_min[lo:hi], **kw
        )
        mjs.append(banded_tb(dirs, bi, bd, band_min[lo:hi], LA=LA, W=W))
        bests.append(best)
        del dirs
    if mjs:
        mj = torch.cat(mjs) if len(mjs) > 1 else mjs[0]
        best = torch.cat(bests) if len(bests) > 1 else bests[0]
    else:
        mj = torch.empty((0, LA), dtype=torch.int32, device=a.device)
        best = torch.empty(0, dtype=torch.int32, device=a.device)
    return torch.cat([metrics_from_mj(mj, best), mj], dim=1)


def banded_align_pairs_plain(
    a, a_len, b, b_len, band_min, *, LA, LB, W, match, mismatch, gap
) -> torch.Tensor:
    """The plain PyTorch version of :func:`banded_align_pairs` on any
    device (used by the CPU path and by the on-card comparisons)."""
    a, a_len, b, b_len, band_min = prepare_inputs(
        a, a_len, b, b_len, band_min, LA=LA, LB=LB, W=W
    )
    dirs, best, bi, bd = banded_fwd_plain(
        a, a_len, b, b_len, band_min,
        LA=LA, LB=LB, W=W, match=match, mismatch=mismatch, gap=gap,
    )
    mj = banded_tb_plain(dirs, bi, bd, band_min, LA=LA, W=W)
    return torch.cat([metrics_from_mj(mj, best), mj], dim=1)


def band_reduce(
    mj: torch.Tensor, orda: torch.Tensor, ordb: torch.Tensor
) -> torch.Tensor:
    """Per-pair [match_count, min_offset, max_offset] (B, 3) int32 with
    offset = orda[i] - ordb[mj[i]] over matched rows (the counterpart
    of align_pallas.py:band_reduce on the int32 layout)."""
    LB = ordb.shape[1]
    matched = mj >= 0
    ob = torch.gather(ordb, 1, mj.clamp(0, max(LB - 1, 0)).to(torch.int64))
    off = orda.to(torch.int32) - ob.to(torch.int32)
    omin = torch.where(matched, off, 2**30).min(dim=1).values
    omax = torch.where(matched, off, -(2**30)).max(dim=1).values
    cnt = matched.sum(dim=1, dtype=torch.int32)
    return torch.stack([cnt, omin.to(torch.int32), omax.to(torch.int32)], dim=1)


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the
    CPU. A CUDA device without a card raises; nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
