"""Batched banded marker alignment: CUDA kernels and their plain version.

Counterpart of ``shasta_tpu/ops/align_pallas.py``. Hand-written CUDA
kernels (``csrc/*.cu``) replace its four Pallas kernels:

- ``banded_fwd`` replaces ``_kernel``'s forward half
  (align_pallas.py:156) and ``_fwd_chunked_kernel`` (:581). It has two
  bodies, picked by the launch's LA and band width (:func:`fwd_body`):
  the anti-diagonal body (``csrc/banded_fwd_diag.cu``, one block per
  pair, a warp per 128 lanes) where W <= ``DIAG_MAX_W`` and
  W <= ``DIAG_W_PER_LA`` * LA, the row-scan body
  (``csrc/banded_align.cu``) elsewhere. The row-scan body computes only
  the live lanes (the matrix and one margin column; :func:`live_lanes`)
  in column coordinates, and writes every other lane's code, which the
  scores fix (:func:`dead_lane_code`), as whole words; its threads are
  sized by the widest column window a pair of the launch can have
  (:func:`rows_plan`): one warp per pair up to 288 columns, one block
  up to 2048, a thread-block cluster up to 32768, strips of 32768 past
  that;
- ``banded_tb`` (``csrc/banded_tb.cu``, one warp per pair) replaces
  ``_kernel``'s traceback half (:296-337), ``_tb_chunked_kernel`` (:714)
  and ``_kernel_waves``'s traceback half (:496-536), which walks each
  pair as ``_kernel`` does;
- ``banded_fwd_waves`` replaces ``_kernel_waves``'s forward half (:340):
  the anti-diagonal body with 2 or 4 pairs per warp on independent
  registers (the same source, ``csrc/banded_fwd_diag.cu``), for the
  launches where :func:`fwd_body` gives "diag" and W <= WAVES_MAX_W.
  ``banded_align_pairs`` runs it when ``SHASTA_TORCH_WAVES`` (or the
  ``waves`` argument) is 2 or 4 and ``banded_fwd`` elsewhere
  (:func:`fwd_kernel`).

The TPU splits monolithic and chunked regimes because of its VMEM
budget; the card has no such budget, so one kernel pair serves every
LA and every W (the row-scan body keeps its rows in registers or shared
memory at every width). The forward kernel writes the 2-bit direction
codes (16 rows to an int32 word) to device memory; the traceback kernel
walks them back.

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

``match_compact`` (``csrc/match_compact.cu``) replaces no TPU kernel: it
writes the kept rows' matches of a fused batch straight into the
alignment store's CSR on the card, where the JAX package fetches them
and scatters them on the host.

``kmer_table`` (``csrc/kmer_table.cu``) replaces no TPU kernel either: it
computes alignMethod 3's k-mer downsampling hash table
(``data/kmers.py:downsampling_hash_table``) on the card, where the JAX
package computes it with numpy on the host. Its plain version is that
numpy function; it takes CUDA tensors alone.

A wrapper runs the plain PyTorch version only because its tensors lie on
the CPU; on CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
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
LAUNCHES = {"banded_fwd": 0, "banded_tb": 0, "banded_fwd_waves": 0}

# Launches of match_compact, its own count: LAUNCHES holds the DP kernels
# alone (the benchmark sums its values into DP launches per candidate),
# and TRACE prices every entry as a DP launch, so neither records it.
COMPACT_LAUNCHES = 0

# Launches of kmer_table, the downsampling hash table's kernel: no DP
# launch either.
KMER_TABLE_LAUNCHES = 0

# Optional launch trace: when a caller sets this to a list, every DP
# launch appends (name, body, LA, W, B, work, start, end) with CUDA
# events recorded around it on the current stream. body: "diag" or
# "rows" for the forward kernels, "warp" for the traceback; work, for
# what a launch really does: (a_len, b_len, band_min, LB), the clamped
# device inputs, of a forward launch (in_matrix_cells counts its cells),
# (bi,), the best-end rows, of a traceback. None: no events.
TRACE = None

# int32 operations the forward DP needs on a band cell inside the matrix
# (the bound counts them on in_matrix_cells), with a DPX add-and-max
# (sm_90a's VIADDMNMX) counted as one: match compare and select 2, the
# diag add 1, max(up + gap, diag) 1, max(left + gap, base) 1 (the row's
# LEFT prefix max as a recurrence), the direction code (two compares,
# three selects) 5, the 2-bit pack (shift, or) 2, one validity mask 1.
# The end-cell accumulation and the j == 0 clamp touch O(LA + W) cells
# of a pair and are left out, as are the per-row lane-range tests, which
# a kernel can work out once per row.
# The anti-diagonal body issues more per cell (chip_smoke.py phase 1
# counts its SASS and checks that it issues no fewer).
FWD_INT_OPS_PER_CELL = 13

# Byte budget of the packed dirs of one forward launch.
_DIRS_BYTES = 1 << 30
# The row-scan body's tiers (rows_plan), by the widest column window a
# pair of the launch can have: one warp per pair up to ROWS_WARP_COLS
# columns, one block up to ROWS_BLOCK_COLS, a cluster of one block per
# ROWS_CLUSTER_COLS, 2 to 8, up to ROWS_STRIP_COLS (8 blocks of 512
# threads of 8 columns), strips of ROWS_STRIP_COLS columns past it.
ROWS_WARP_COLS = 32 * 9
ROWS_BLOCK_COLS = 2048
ROWS_CLUSTER_COLS = 4096
ROWS_STRIP_COLS = 32768
# The widest band the anti-diagonal body takes (1024 threads x 4 lanes).
DIAG_W_LIMIT = 4096
# The anti-diagonal body pays a ramp of W / 2 pair steps on every pair,
# so banded_fwd gives it a launch only where W <= DIAG_W_PER_LA * LA.
# Against the row-scan body that computes only the live lanes (PR 9's
# chip_smoke.py phase 2 on an H100, bodies timed in turns; PERF.md) it
# took less time at every shape with LA >= W / 2, W from 33 to 4096
# (LA / W from 1/2 to 31; 1024 x 2048: 1.331 against 1.617 ms), and
# more at every one with LA <= W / 4 (128 x 512, 512 x 2048 and 2049,
# 17 x 512).
DIAG_W_PER_LA = 2
# The widest band banded_fwd gives the anti-diagonal body: its limit,
# DIAG_W_LIMIT. Past 2048 lanes at LA >= W / 2 it was the faster body in
# the same call (2048 x 4096: 4.085 against 4.957 ms; 4096 x 2049: 4.315
# against 10.562 ms).
DIAG_MAX_W = DIAG_W_LIMIT
# The widest band banded_fwd_waves takes: a block of P >= 2 pairs holds
# at most 32 / P warps (csrc/banded_fwd_diag.cu).
WAVES_MAX_W = 2048

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "build", "cuda")
# The built library of every csrc/*.cu kernel (library() loads it).
LIBRARY_PATH = os.path.join(_BUILD_DIR, "libbanded_align.so")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

_lib = None
_lock = threading.Lock()
# ptxas's report (registers, spills) of the last build, per source.
PTXAS_REPORT = {}


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


def kernel_sources() -> tuple[list[str], list[str]]:
    """The CUDA sources under csrc/, sorted: the ``*.cu`` files (one
    object each) and the ``*.cuh`` headers they include."""
    names = sorted(os.listdir(_CSRC_DIR))
    cu = [os.path.join(_CSRC_DIR, n) for n in names if n.endswith(".cu")]
    cuh = [os.path.join(_CSRC_DIR, n) for n in names if n.endswith(".cuh")]
    return cu, cuh


def build_commands(nvcc: str, out: str) -> tuple[list[list[str]], list[str]]:
    """The nvcc command lines that build the library ``out``: one
    compile per ``*.cu`` (run together, each printing ptxas's register
    and spill report), then the link of their objects."""
    cu, _ = kernel_sources()
    objs = [f"{out}.{os.path.basename(c)[:-3]}.o" for c in cu]
    compiles = [
        [nvcc, *_NVCC_FLAGS, "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-c", "-o", o, c]
        for c, o in zip(cu, objs)
    ]
    link = [nvcc, *_NVCC_FLAGS, "-shared", "-o", out, *objs]
    return compiles, link


def library_stale(so: str = None) -> bool:
    """True when the library is missing or older than any source."""
    so = so or LIBRARY_PATH
    if not os.path.exists(so):
        return True
    cu, cuh = kernel_sources()
    return os.path.getmtime(so) < max(os.path.getmtime(f) for f in cu + cuh)


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; their stderr, or raise if any failed."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    errs = [proc.communicate()[1] for proc in procs]
    failed = [
        f"{' '.join(c)} ({proc.returncode}):\n{err}"
        for c, proc, err in zip(cmds, procs, errs) if proc.returncode != 0
    ]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return errs


def build_kernels(force: bool = False) -> float:
    """Compile every csrc/*.cu for sm_90a (one nvcc each, all at once),
    link them into the git-ignored build directory and load the
    library. Returns the build seconds (0 when the library was already
    built from the current sources)."""
    global _lib
    with _lock:
        t0 = time.perf_counter()
        if force or library_stale():
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{LIBRARY_PATH}.{os.getpid()}.tmp"
            compiles, link = build_commands(_nvcc(), tmp)
            try:
                errs = _run_all(compiles)
                _run_all([link])
                PTXAS_REPORT.clear()
                PTXAS_REPORT.update(
                    (os.path.basename(c[-1]), e) for c, e in zip(compiles, errs)
                )
            finally:
                for c in compiles:  # [..., "-o", object, source]
                    if os.path.exists(c[-2]):
                        os.remove(c[-2])
            os.replace(tmp, LIBRARY_PATH)
            _lib = None
        if _lib is None:
            lib = ctypes.CDLL(LIBRARY_PATH)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.banded_fwd_diag_launch.argtypes = [vp] * 5 + [ci] * 7 + [vp] * 5
            lib.banded_fwd_diag_launch.restype = ci
            # banded_fwd_rows_launch takes its plan (tier, columns a
            # thread, threads, blocks a pair) and strip_edges after the
            # scores.
            lib.banded_fwd_rows_launch.argtypes = [vp] * 5 + [ci] * 11 + [vp] * 6
            lib.banded_fwd_rows_launch.restype = ci
            lib.banded_tb_launch.argtypes = [vp] * 4 + [ci] * 3 + [vp] * 2
            lib.banded_tb_launch.restype = ci
            # banded_fwd_waves_launch takes waves after the scores.
            lib.banded_fwd_waves_launch.argtypes = [vp] * 5 + [ci] * 8 + [vp] * 5
            lib.banded_fwd_waves_launch.restype = ci
            # utils/peak.py's int32 ceiling (csrc/int32_peak.cu).
            lib.int32_chain_launch.argtypes = [vp, ci, ci, vp, vp]
            lib.int32_chain_launch.restype = ci
            # match_compact_launch(fused, B, LA, dst, ord0, ord1,
            # out_bytes, stream) (csrc/match_compact.cu).
            lib.match_compact_launch.argtypes = [vp, ci, ci, vp, vp, vp, ci, vp]
            lib.match_compact_launch.restype = ci
            # kmer_table_launch(out, k, stream) (csrc/kmer_table.cu).
            lib.kmer_table_launch.argtypes = [vp, ci, vp]
            lib.kmer_table_launch.restype = ci
            _lib = lib
        return time.perf_counter() - t0


def library():
    """The loaded ctypes library of every csrc/*.cu kernel (at
    LIBRARY_PATH), built on first use."""
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


def _trace_end(start, name, body, LA, W, B, work) -> None:
    if start is None:
        return
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    TRACE.append((name, body, LA, W, B, work, start, end))


# ---------------------------------------------------------------------------
# The two kernels' wrappers (CUDA tensors) and their plain versions
# ---------------------------------------------------------------------------


def n_words(LA: int) -> int:
    """Packed dirs words per lane: 16 rows of 2-bit codes per int32."""
    return (LA + 15) // 16


def dead_lane_code(match: int, mismatch: int, gap: int) -> int:
    """The 2-bit code of every lane of a processed row outside
    0 <= j <= b_len + 1: both previous-row neighbours NEG_INF (outside
    the matrix, or the margin column's invalid V) and b padding, so no
    match; the cell formula then gives a code the scores fix (3, LEFT,
    at 6/-1/-1). The row-scan body's launcher works it out alike."""
    diag = NEG_INF + mismatch
    base = max(diag, NEG_INF + gap)
    return LEFT if NEG_INF > base else (D_MISMATCH if base == diag else UP)


def live_lanes(a_len, b_len, band_min, *, LA, W):
    """Each pair's live lanes per row: (lo, hi), (B, LA) int32, row i + 1
    live from lane lo to lane hi (lo > hi: none; rows past a_len have
    none). A lane d of row i is live when its column j = i + band_min + d
    lies in 0 <= j <= b_len + 1: the matrix and the margin column."""
    dev = a_len.device
    i = torch.arange(1, LA + 1, dtype=torch.int64, device=dev)[None, :]
    r0 = band_min.to(torch.int64)[:, None] + i
    lo = torch.clamp(-r0, min=0)
    hi = torch.clamp(b_len.to(torch.int64)[:, None] + 1 - r0, max=W - 1)
    hi = torch.where(i <= a_len.to(torch.int64)[:, None], hi, lo - 1)
    hi = torch.maximum(hi, lo - 1)
    return lo.to(torch.int32), hi.to(torch.int32)


def in_matrix_cells(a_len, b_len, band_min, *, LA, W, chunk=1 << 22) -> int:
    """The band cells of processed rows inside the matrix
    (0 <= j <= b_len): the cells whose work the forward bound counts.
    Summed over row blocks of at most ``chunk`` cells."""
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


def rows_plan(LA: int, LB: int, W: int) -> dict:
    """The row-scan body's launch shape, from the widest column window a
    pair can have, S = min(LB + 2, LA + W): "warp" (one warp per pair,
    four pairs a block, K = 5 or 9 columns a thread) up to
    ROWS_WARP_COLS; "block" (one block per pair of up to 512 threads of
    4 columns) up to ROWS_BLOCK_COLS; "cluster" (one block per
    ROWS_CLUSTER_COLS, 2 to 8, each of up to 512 threads of KC = 4 or
    8 columns, the fewer that hold the block's share of
    min(S, ROWS_STRIP_COLS)) past it; strips of ROWS_STRIP_COLS past
    that. csrc/banded_align.cu launches what it gives."""
    S = min(LB + 2, LA + W)
    if S <= ROWS_WARP_COLS:
        K = 5 if S <= 32 * 5 else 9
        return dict(tier="warp", cols_per_thread=K, threads=128, blocks=1, strips=1, window=S)
    C = 1 if S <= ROWS_BLOCK_COLS else min(8, max(2, -(-S // ROWS_CLUSTER_COLS)))
    share = -(-min(S, ROWS_STRIP_COLS) // C)  # the columns of one block
    KC = 4 if share <= 512 * 4 else 8
    T = (-(-share // KC) + 31) // 32 * 32
    return dict(tier="block" if C == 1 else "cluster", cols_per_thread=KC, threads=T,
                blocks=C, strips=-(-S // (C * T * KC)), window=S)


def fwd_body(LA: int, W: int) -> str:
    """The body banded_fwd runs on a launch of LA rows and band width W:
    "diag" (anti-diagonal) where W <= DIAG_MAX_W and
    W <= DIAG_W_PER_LA * LA, "rows" (row scan) elsewhere."""
    return "diag" if W <= min(DIAG_MAX_W, DIAG_W_PER_LA * LA) else "rows"


def banded_fwd(a, a_len, b, b_len, band_min, *, LA, LB, W, match, mismatch, gap):
    """Forward DP on prepared (clamped) inputs. Returns
    (dirs (B, ceil(LA/16), W) int32, best, bi, bd (B,) int32). Rows
    beyond a pair's a_len are not written (the traceback never reads
    them). On CUDA tensors it runs the body :func:`fwd_body` picks."""
    kw = dict(LA=LA, LB=LB, W=W, match=match, mismatch=mismatch, gap=gap)
    if a.device.type != "cuda":
        return banded_fwd_plain(a, a_len, b, b_len, band_min, **kw)
    return _banded_fwd_body(fwd_body(LA, W), a, a_len, b, b_len, band_min, **kw)


def _banded_fwd_body(
    body, a, a_len, b, b_len, band_min, *, LA, LB, W, match, mismatch, gap, plan=None
):
    """banded_fwd's launch of one body, "diag" (W <= DIAG_W_LIMIT) or
    "rows" (any W), on CUDA tensors; both give the same outputs.
    chip_smoke.py and the card tests run both bodies through it. plan:
    the row-scan body's launch shape (default :func:`rows_plan`'s; any
    shape the launcher takes gives the same outputs)."""
    _check_cuda(a, a_len, b, b_len, band_min)
    if body not in ("diag", "rows") or (body == "diag" and W > DIAG_W_LIMIT):
        raise ValueError(
            f"banded_fwd's {body!r} body: 'diag' takes W <= {DIAG_W_LIMIT}, "
            f"'rows' any W; got W={W}"
        )
    extra = ()
    if body == "rows":
        plan = plan or rows_plan(LA, LB, W)
        # Past one strip each strip passes every row's edge to the next
        # through this buffer; the caching allocator does not hand it out
        # again before the launch's stream has passed it.
        edges = None
        if plan["strips"] > 1:
            edges = torch.empty(
                a.shape[0] * 2 * (LA + 1), dtype=torch.int32, device=a.device
            )
        extra = (
            0 if plan["tier"] == "warp" else 1, plan["cols_per_thread"], plan["threads"],
            plan["blocks"], None if edges is None else edges.data_ptr(),
        )
    return _launch_fwd(
        "banded_fwd", body, a, a_len, b, b_len, band_min, LA, LB, W,
        match, mismatch, gap, *extra,
    )


def banded_fwd_waves(
    a, a_len, b, b_len, band_min, *, LA, LB, W, match, mismatch, gap, waves
):
    """:func:`banded_fwd` with ``waves`` (2 or 4) pairs per warp, for the
    launches where :func:`fwd_kernel` gives it (:func:`fwd_body` gives
    "diag" and W <= WAVES_MAX_W): the same outputs, bit for bit. It
    raises on any other shape (it does not run the row-scan body) and on
    any other ``waves``, on every device. A batch that is not a multiple
    of ``waves`` leaves the last block's extra slots empty (the kernel
    guards them)."""
    if waves not in (2, 4) or fwd_kernel(LA, W, waves) != "banded_fwd_waves":
        raise ValueError(
            f"banded_fwd_waves takes waves 2 or 4 and the anti-diagonal "
            f"body's shapes up to W {WAVES_MAX_W} (W <= {DIAG_W_PER_LA} LA); "
            f"got LA={LA} W={W} waves={waves}"
        )
    if a.device.type != "cuda":
        return banded_fwd_plain(
            a, a_len, b, b_len, band_min,
            LA=LA, LB=LB, W=W, match=match, mismatch=mismatch, gap=gap,
        )
    _check_cuda(a, a_len, b, b_len, band_min)
    return _launch_fwd(
        "banded_fwd_waves", "diag", a, a_len, b, b_len, band_min, LA, LB, W,
        match, mismatch, gap, waves,
    )


_FWD_LAUNCHERS = {
    ("banded_fwd", "diag"): "banded_fwd_diag_launch",
    ("banded_fwd", "rows"): "banded_fwd_rows_launch",
    ("banded_fwd_waves", "diag"): "banded_fwd_waves_launch",
}


def _launch_fwd(name, body, a, a_len, b, b_len, band_min, LA, LB, W, match,
                mismatch, gap, *extra):
    """Allocate the forward outputs and launch kernel ``name``'s
    ``body`` through its C launcher, which takes ``extra`` after the
    scores."""
    B = a.shape[0]
    dev = a.device
    dirs = torch.empty((B, n_words(LA), W), dtype=torch.int32, device=dev)
    best = torch.empty(B, dtype=torch.int32, device=dev)
    bi = torch.empty(B, dtype=torch.int32, device=dev)
    bd = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return dirs, best, bi, bd
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ev = _trace_start()
    rc = getattr(lib, _FWD_LAUNCHERS[name, body])(
        a.data_ptr(), b.data_ptr(), a_len.data_ptr(), b_len.data_ptr(),
        band_min.data_ptr(), B, LA, LB, W, match, mismatch, gap, *extra,
        dirs.data_ptr(), best.data_ptr(), bi.data_ptr(), bd.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{name} ({body}) launch failed (cudaError {rc}) at "
            f"B={B} LA={LA} LB={LB} W={W} {extra}"
        )
    LAUNCHES[name] += 1
    _trace_end(ev, name, body, LA, W, B, (a_len, b_len, band_min, LB))
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
    lib = library()
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
    _trace_end(ev, "banded_tb", "warp", LA, W, B, (bi,))
    return mj


def banded_fwd_plain(
    a, a_len, b, b_len, band_min, *, LA, LB, W, match, mismatch, gap
):
    """The forward DP as a row loop of int32 torch ops (the counterpart
    of shasta_tpu/ops/align.py:_banded_forward, with the Pallas
    kernel's packed 2-bit dirs layout and best-end accumulator). Codes
    of rows beyond a pair's a_len are 0, like the kernel's unwritten
    bits of a partly filled word.

    What does not depend on the previous row (the b gather, the match,
    the validity and end masks) is computed for the 16 rows of a dirs
    word at once, (B, 16, W); the loop carries only the recurrence."""
    B = a.shape[0]
    dev = a.device
    i32 = torch.int32
    d_idx = torch.arange(W, dtype=i32, device=dev)[None, :]
    d3 = d_idx[:, None, :]
    dgap = d_idx * gap
    neg_col = torch.full((B, 1), NEG_INF, dtype=i32, device=dev)
    bm = band_min[:, None, None]
    bl = b_len[:, None, None]
    al = a_len[:, None, None]
    j0 = band_min[:, None] + d_idx
    prev = torch.where((j0 >= 0) & (j0 <= b_len[:, None]), 0, NEG_INF).to(i32)
    bv = torch.full((B, W), NEG_INF, dtype=i32, device=dev)
    bim = torch.zeros((B, W), dtype=i32, device=dev)
    words = torch.zeros((B, n_words(LA), W), dtype=torch.int64, device=dev)
    for w in range(n_words(LA)):
        R = min(16, LA - 16 * w)
        ii = torch.arange(16 * w + 1, 16 * w + R + 1, dtype=i32, device=dev)[None, :, None]
        j = bm + ii + d3
        jm1 = j - 1
        inb = (jm1 >= 0) & (jm1 < LB)
        idx = jm1.clamp(0, max(LB - 1, 0)).to(torch.int64).reshape(B, R * W)
        bj = torch.where(inb, torch.gather(b, 1, idx).reshape(B, R, W), -2)
        m = bj == a[:, 16 * w : 16 * w + R, None]
        sub = torch.where(m, match, mismatch).to(i32)
        valid = (j >= 0) & (j <= bl) & (ii <= al)
        at_j0 = j == 0
        iscol = (j == bl) & valid
        endm = iscol | ((al == ii) & valid)
        end_key = torch.where(iscol, 2 * ii, 2 * ii + 1).to(i32)
        codes = torch.zeros((B, R, W), dtype=torch.int64, device=dev)
        for r in range(R):
            prev_up = torch.cat([prev[:, 1:], neg_col], dim=1)
            diag = prev + sub[:, r]
            base = torch.maximum(diag, prev_up + gap)
            base = torch.where(at_j0[:, r], torch.clamp(base, min=0), base)
            run = torch.cummax(base - dgap, dim=1).values.clamp(min=NEG_INF)
            V = torch.where(valid[:, r], run + dgap, NEG_INF).to(i32)
            codes[:, r] = torch.where(
                V > base, LEFT,
                torch.where(base == diag, torch.where(m[:, r], D_MATCH, D_MISMATCH), UP),
            )
            mv = torch.where(endm[:, r], V, NEG_INF)
            bt = mv > bv
            bv = torch.where(bt, mv, bv)
            bim = torch.where(bt, end_key[:, r], bim)
            prev = V
        codes = torch.where(al >= ii, codes, 0)
        shift = 2 * torch.arange(R, dtype=torch.int64, device=dev)[None, :, None]
        words[:, w, :] = (codes << shift).sum(dim=1)
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
    j == 0 cell read as the terminal code 4. The codes of a dirs word's
    16 rows are unpacked at once, and their matches read off after the
    walk has crossed them; the loop carries the walk."""
    B = dirs.shape[0]
    dev = dirs.device
    i32 = torch.int32
    d_idx = torch.arange(W, dtype=i32, device=dev)[None, :]
    d3 = d_idx[:, None, :]
    entry = torch.full((B, 1), -1, dtype=i32, device=dev)
    bd = bd[:, None]
    mj = torch.empty((B, LA), dtype=i32, device=dev)
    for w in range(n_words(LA) - 1, -1, -1):
        R = min(16, LA - 16 * w)
        ii = torch.arange(16 * w + 1, 16 * w + R + 1, dtype=i32, device=dev)[None, :]
        code = (dirs[:, w, None, :] >> (2 * (ii - 1) % 32)[:, :, None]) & 3
        # jb: the column of lane 0 on row i, band_min + i.
        jb = band_min[:, None] + ii
        adj = torch.where(jb[:, :, None] + d3 == 0, 4, code)
        key = torch.where(adj != LEFT, d3 * 8 + adj, -1).to(i32)
        start = bi[:, None] == ii
        kbuf = torch.empty((B, R), dtype=i32, device=dev)
        for r in range(R - 1, -1, -1):
            entry = torch.where(start[:, r : r + 1], bd, entry)
            kmax = torch.where(d_idx <= entry, key[:, r], -1).max(dim=1, keepdim=True).values
            kbuf[:, r : r + 1] = kmax
            exit_d = kmax >> 3
            acode = kmax & 7
            entry = torch.where(
                acode <= D_MISMATCH, exit_d, torch.where(acode == UP, exit_d + 1, -1)
            )
            entry = torch.where(entry >= W, -1, entry).to(i32)
        # Each row's match: its exit column, where it left on a match.
        j_exit = jb + (kbuf >> 3)
        is_match = ((kbuf & 7) == D_MATCH) & (j_exit > 0)
        mj[:, 16 * w : 16 * w + R] = torch.where(is_match, j_exit - 1, -1)
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


def resolve_waves(waves=None) -> int:
    """Pairs per forward thread block: ``waves``, or when it is None the
    ``SHASTA_TORCH_WAVES`` environment variable (default 1), read anew
    on every call. Only 1, 2 and 4 are allowed."""
    if waves is None:
        waves = os.environ.get("SHASTA_TORCH_WAVES", "1")
    if str(waves) not in ("1", "2", "4"):
        raise ValueError(f"waves must be 1, 2 or 4; got {waves!r}")
    return int(waves)


def fwd_kernel(LA: int, W: int, waves: int) -> str:
    """The forward kernel banded_align_pairs launches for ``waves`` pairs
    per warp: "banded_fwd_waves" where waves > 1, :func:`fwd_body` gives
    "diag" and W <= WAVES_MAX_W, "banded_fwd" elsewhere. This is the
    port's form of ``_invoke``'s fallback to ``_kernel`` where its waves
    condition fails (align_pallas.py:1159); the output is the same
    either way."""
    if waves > 1 and fwd_body(LA, W) == "diag" and W <= WAVES_MAX_W:
        return "banded_fwd_waves"
    return "banded_fwd"


def banded_align_pairs(
    a, a_len, b, b_len, band_min, *, LA, LB, W, match, mismatch, gap, waves=None
) -> torch.Tensor:
    """Forward + traceback for a batch of pairs; (B, 16 + LA) int32.

    CPU tensors run the plain version; CUDA tensors run the kernels,
    in launches of at most :func:`dirs_chunk_pairs` pairs each.

    ``waves`` (:func:`resolve_waves`; None reads ``SHASTA_TORCH_WAVES``)
    and the shape pick the forward kernel (:func:`fwd_kernel`): 1 runs
    ``banded_fwd``; 2 or 4 run ``banded_fwd_waves`` where the
    anti-diagonal body takes the shape and ``banded_fwd`` elsewhere."""
    waves = resolve_waves(waves)
    a, a_len, b, b_len, band_min = prepare_inputs(
        a, a_len, b, b_len, band_min, LA=LA, LB=LB, W=W
    )
    B = a.shape[0]
    kw = dict(LA=LA, LB=LB, W=W, match=match, mismatch=mismatch, gap=gap)
    if fwd_kernel(LA, W, waves) == "banded_fwd_waves":
        fwd = functools.partial(banded_fwd_waves, waves=waves)
    else:
        fwd = banded_fwd
    step = dirs_chunk_pairs(LA, W)
    mjs, bests = [], []
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        dirs, best, bi, bd = fwd(
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


def match_compact(fused, dst, ord0, ord1) -> None:
    """Write the kept rows' matches of a fused batch into a flat CSR: for
    each row b of ``fused`` ((B, 16 + LA) int32, as banded_align_pairs
    gives it) with ``dst[b] >= 0``, its k-th match in column (path)
    order goes to ``ord0[dst[b] + k]`` (the column, ordinal0) and
    ``ord1[dst[b] + k]`` (its value, ordinal1). ``dst`` (B,) int64, -1
    where the pair is not kept; ``ord0``, ``ord1`` flat int16 tensors
    holding the store's uint16 ordinals, or int32 holding uint32. No
    other element is written. CPU tensors run the plain version; CUDA
    tensors launch ``csrc/match_compact.cu`` or raise."""
    global COMPACT_LAUNCHES
    if fused.device.type != "cuda":
        return match_compact_plain(fused, dst, ord0, ord1)
    dev = fused.device
    if any(t.device != dev for t in (dst, ord0, ord1)):
        raise ValueError("match_compact: all inputs must be on one device")
    if fused.dim() != 2 or fused.shape[1] < 16 or fused.dtype != torch.int32:
        raise ValueError(f"match_compact: fused must be (B, 16 + LA) int32, got "
                         f"{tuple(fused.shape)} {fused.dtype}")
    if dst.dtype != torch.int64 or tuple(dst.shape) != (fused.shape[0],):
        raise ValueError(f"match_compact: dst must be ({fused.shape[0]},) int64, got "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if ord0.dtype != ord1.dtype or ord0.dtype not in (torch.int16, torch.int32):
        raise ValueError("match_compact: ord0 and ord1 must both be int16 or int32")
    if not all(t.is_contiguous() for t in (fused, dst, ord0, ord1)):
        raise ValueError("match_compact: inputs must be contiguous")
    B, LA = fused.shape[0], fused.shape[1] - 16
    if B == 0:
        return
    rc = library().match_compact_launch(
        fused.data_ptr(), B, LA, dst.data_ptr(), ord0.data_ptr(), ord1.data_ptr(),
        ord0.element_size(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"match_compact launch failed (cudaError {rc}) at B={B} LA={LA}")
    COMPACT_LAUNCHES += 1


def match_compact_plain(fused, dst, ord0, ord1) -> None:
    """The plain PyTorch version of :func:`match_compact`, on any device:
    a nonzero over the kept rows' matches (row-major, so each row's in
    column order) and one indexed write per array. Values are cast to
    the arrays' int16/int32, which keeps the bits of uint16/uint32."""
    dev = fused.device
    rows = torch.nonzero(dst >= 0).flatten()
    if rows.numel() == 0:
        return
    mj = fused.index_select(0, rows)[:, 16:]
    r, c = torch.nonzero(mj >= 0, as_tuple=True)
    first = torch.searchsorted(r, torch.arange(rows.numel(), device=dev))
    pos = dst[rows][r] + torch.arange(r.numel(), device=dev) - first[r]
    ord0[pos] = c.to(ord0.dtype)
    ord1[pos] = mj[r, c].to(ord1.dtype)


def kmer_table(out: torch.Tensor, k: int) -> None:
    """Write the downsampling hash of every k-mer id of k into ``out``
    ((4^k,) int32 holding the hashes' uint32 bits, contiguous, 16-byte
    aligned, on a card): for id x, MurmurHash2 of the key x + rc(x), seed
    13477, as ``data/kmers.py:kmer_downsampling_hash`` (numpy, its plain
    version) computes it. Launches ``csrc/kmer_table.cu``; raises on
    anything else."""
    global KMER_TABLE_LAUNCHES
    if out.device.type != "cuda":
        raise ValueError(f"kmer_table: out must be on a card, got {out.device}")
    if not 1 <= k <= 16:
        raise ValueError(f"kmer_table: k {k} is not in 1 .. 16")
    if out.shape != (1 << (2 * k),) or out.dtype != torch.int32 or not out.is_contiguous():
        raise ValueError(f"kmer_table: out must be a contiguous (4^{k},) int32 tensor, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if out.data_ptr() % 16 != 0:
        raise ValueError("kmer_table: out must be 16-byte aligned")
    rc = library().kmer_table_launch(
        out.data_ptr(), k, torch.cuda.current_stream(out.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"kmer_table launch failed (cudaError {rc}) at k={k}")
    KMER_TABLE_LAUNCHES += 1


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
