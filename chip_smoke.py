"""Drive shasta_tpu_torch on one NVIDIA card and hold it to its references.

    python3 chip_smoke.py            # needs one CUDA device

Phases (any failure raises; the script then exits non-zero and prints
no result line):

1. Device and build: the card's name and power limit, then the CUDA
   kernels built from shasta_tpu_torch/csrc with nvcc (the native host
   library builds beside it, in parallel).
2. Kernels against their plain PyTorch version on the card, at the
   main path's (LA, W) classes: exact int32 equality of each kernel's
   output and of the fused (B, 16 + LA) result; times, Gcells/s and the
   least time the card could take (the bound).
3. The golden slice (tests/golden/mode0_stage_hashes.json's input) run
   through the port's Assembler on the card and on the CPU: equal stage
   hashes, equal to the pinned values.
4. The slice at a real size on the card: a 5 Mb random genome, ONT-like
   reads at 25x, Nanopore-May2022 verbatim. The launch counts are reset
   just before the six stages and read just after; 256 kept pairs are
   re-aligned with the plain version on the card and must agree.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
GOLDEN = os.path.join(ROOT, "tests", "golden", "mode0_stage_hashes.json")
STAGES = ["Reads", "Kmers", "Markers", "AlignmentCandidates", "Alignments"]
SCORES = dict(match=6, mismatch=-1, gap=-1)
# (LA = LB, W, pairs): phase 1's class, the phase-2 classes (4096 x 128
# takes the most kernel time on the real-size run), a wide band, the
# ultra-long classes, and a band past 4096 lanes (the forward kernel's
# 16-lanes-per-thread instantiation, which a max_band above 2047 reaches).
SHAPES = [
    (128, 512, 2048), (2048, 128, 512), (4096, 512, 256), (1024, 2048, 128),
    (4096, 128, 256), (8192, 512, 64), (32768, 128, 64), (512, 8192, 8),
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 units
TB_OPS_PER_ROW = 12  # banded_tb_kernel's int32 work per walked row


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def phase_device_and_build():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from shasta_tpu_torch import native
    from shasta_tpu_torch.ops import align_kernel as K

    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi('name,power.limit')}")
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}"
    )
    native_ok = []
    t = threading.Thread(target=lambda: native_ok.append(native.available()))
    t0 = time.perf_counter()
    t.start()
    nvcc_s = K.build_kernels(force=True)
    t.join()
    log(
        f"build: nvcc {nvcc_s:.2f}s (csrc/banded_align.cu, sm_90a); native "
        f"host library {'ok' if native_ok[0] else 'unavailable'}; "
        f"wall {time.perf_counter() - t0:.2f}s"
    )
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
    return sm_clock_mhz


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


def make_batch(seed, B, LA, W, alpha=1000):
    """Seeded pairs: shifted copies of one sequence with ~8% random
    substitutions (real matches inside the band), plus an empty pair and
    bands partly and wholly outside the matrix."""
    rng = np.random.default_rng(seed)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LA), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    for t in range(B):
        g = rng.integers(0, alpha, 2 * LA + W).astype(np.int32)
        la = int(rng.integers(LA // 2, LA + 1))
        lb = int(rng.integers(LA // 2, LA + 1))
        sa = int(rng.integers(0, W // 2 + 1))
        sb = max(0, sa + int(rng.integers(-(W // 4), W // 4 + 1)))
        a[t, :la] = g[sa : sa + la]
        b[t, :lb] = g[sb : sb + lb]
        sub = rng.random(la) < 0.08
        a[t, :la][sub] = rng.integers(0, alpha, int(sub.sum()))
        a_len[t], b_len[t] = la, lb
        bm[t] = -(W // 2) + int(rng.integers(-(W // 8), W // 8 + 1))
    a_len[0] = 0
    bm[1] = -(LA + W) - 7
    bm[2] = LA + 1
    bm[3] = -(LA + W) + W // 2
    return a, a_len, b, b_len, bm


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops, nbytes, sm_clock_mhz):
    """(bound, what bounds it, operations time, bytes time), all ms: int32
    operations over the card's int32 issue rate at the SM clock, and
    bytes over the HBM rate."""
    peak_ops = torch.cuda.get_device_properties(0).multi_processor_count * (
        INT32_LANES_PER_SM * sm_clock_mhz * 1e6
    )
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, t_ops, t_bytes


def class_bound(name, LA, W, B, work, sm_clock_mhz):
    """The bound of one main-path (kernel, LA, W) class from the work
    its launches really did: banded_fwd's processed band cells (the
    inputs read, 2 bits of dirs written per cell), banded_tb's walked
    rows (one dirs word read per row, the (B, LA) matches written)."""
    from shasta_tpu_torch.ops import align_kernel as K

    if name == "banded_fwd":
        return bound_ms(
            work * K.FWD_INT_OPS_PER_CELL, 4 * B * 2 * LA + 4 * 5 * B + work // 4,
            sm_clock_mhz,
        )
    return bound_ms(work * TB_OPS_PER_ROW, 4 * B * LA + 4 * work + 16 * B, sm_clock_mhz)


def phase_kernels(sm_clock_mhz):
    from shasta_tpu_torch.ops import align_kernel as K

    results = {}
    for LA, W, B in SHAPES:
        kw = dict(LA=LA, LB=LA, W=W, **SCORES)
        host = make_batch(LA * 7 + W, B, LA, W)
        dev = [torch.from_numpy(x).cuda() for x in host]
        a, a_len, b, b_len, bm = K.prepare_inputs(*dev, LA=LA, LB=LA, W=W)

        # The plain version once, timed: forward, then traceback.
        t0 = time.perf_counter()
        pdirs, pbest, pbi, pbd = K.banded_fwd_plain(a, a_len, b, b_len, bm, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pmj = K.banded_tb_plain(pdirs, pbi, pbd, bm, LA=LA, W=W)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pfused = torch.cat([K.metrics_from_mj(pmj, pbest), pmj], dim=1)

        # banded_fwd against the plain forward: best/bi/bd, and every
        # dirs word that holds a processed row (the traceback reads no
        # other).
        dirs, best, bi, bd = K.banded_fwd(a, a_len, b, b_len, bm, **kw)
        torch.cuda.synchronize()
        words = (torch.arange(K.n_words(LA), device="cuda")[None, :] * 16) < a_len[:, None]
        fwd_err = max(
            int((best - pbest).abs().max()), int((bi - pbi).abs().max()),
            int((bd - pbd).abs().max()),
            int(((dirs != pdirs) & words[:, :, None]).sum()),
        )
        # banded_tb against the plain traceback on the same inputs.
        mj = K.banded_tb(pdirs, pbi, pbd, bm, LA=LA, W=W)
        torch.cuda.synchronize()
        tb_err = int((mj - pmj).abs().max())
        # The public fused output, kernels end to end, against the plain.
        fused = K.banded_align_pairs(*dev, **kw)
        torch.cuda.synchronize()
        fused_err = int((fused - pfused).abs().max())
        if fwd_err or tb_err or fused_err:
            raise AssertionError(
                f"kernel != plain at LA={LA} W={W}: fwd {fwd_err} tb {tb_err} "
                f"fused {fused_err}"
            )
        n_matched = int(fused[:, 0].sum())
        if n_matched == 0:
            raise AssertionError(f"no matches at LA={LA} W={W}: a vacuous check")

        reps = 20 if LA * W <= 1 << 20 else 5
        fwd_ms = cuda_ms(lambda: K.banded_fwd(a, a_len, b, b_len, bm, **kw), reps)
        tb_ms = cuda_ms(lambda: K.banded_tb(dirs, bi, bd, bm, LA=LA, W=W), reps)

        rows = int(a_len.clamp(max=LA).sum())
        cells = rows * W
        fwd_bytes = 4 * B * 2 * LA + 4 * 5 * B + sum(
            -(-int(r) // 16) * W * 4 for r in a_len.tolist()
        )
        fwd_bound, fwd_by, fwd_ops_ms, fwd_bytes_ms = bound_ms(
            cells * K.FWD_INT_OPS_PER_CELL, fwd_bytes, sm_clock_mhz
        )
        # The same cells at the operations the kernel issues as written,
        # a separate figure (not the bound).
        fwd_issued_ms = fwd_ops_ms * K.FWD_INT_OPS_PER_CELL_ISSUED / K.FWD_INT_OPS_PER_CELL
        walked = int(bi.sum())
        tb_bound, tb_by, tb_ops_ms, tb_bytes_ms = bound_ms(
            walked * TB_OPS_PER_ROW, 4 * B * LA + 4 * walked + 16 * B, sm_clock_mhz
        )
        gcells = B * LA * W / ((fwd_ms + tb_ms) * 1e-3) / 1e9
        results[(LA, W)] = {
            "LA": LA, "W": W, "B": B, "matched": n_matched,
            "fwd_ms": fwd_ms, "tb_ms": tb_ms,
            "fwd_plain_ms": (t1 - t0) * 1e3, "tb_plain_ms": (t2 - t1) * 1e3,
            "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
            "fwd_ops_ms": fwd_ops_ms, "fwd_bytes_ms": fwd_bytes_ms,
            "fwd_issued_ops_ms": fwd_issued_ms,
            "tb_bound_ms": tb_bound, "tb_bound_by": tb_by,
            "tb_ops_ms": tb_ops_ms, "tb_bytes_ms": tb_bytes_ms,
            "gcells_per_s": gcells, "max_abs_err": max(fwd_err, tb_err, fused_err),
        }
        log(
            f"kernel LA={LA} W={W} B={B}: equal (matches {n_matched}); "
            f"fwd {fwd_ms:.3f} ms (plain {(t1 - t0) * 1e3:.1f} ms, bound "
            f"{fwd_bound:.4f} ms by {fwd_by}, {fwd_bound / fwd_ms:.1%}; dirs and "
            f"inputs {fwd_bytes_ms:.4f} ms at 3.35 TB/s; the kernel's issued "
            f"operations {fwd_issued_ms:.4f} ms); "
            f"tb {tb_ms:.3f} ms (plain {(t2 - t1) * 1e3:.1f} ms, bound "
            f"{tb_bound:.4f} ms by {tb_by}, {tb_bound / tb_ms:.1%}); "
            f"{gcells:.2f} Gcells/s (B*LA*W / fwd+tb)"
        )
        del dirs, pdirs, fused, pfused, pmj, mj
    return results


# ---------------------------------------------------------------------------
# Phases 3 and 4
# ---------------------------------------------------------------------------


def small_config():
    """tests/test_assembly_e2e.py:small_config, written out."""
    from shasta_tpu_torch.pipeline.config import AssemblyConfig

    cfg = AssemblyConfig()
    cfg.reads.min_read_length = 500
    cfg.kmers.k = 8
    cfg.kmers.probability = 0.1
    cfg.min_hash.hash_fraction = 0.05
    cfg.min_hash.min_hash_iteration_count = 6
    cfg.min_hash.max_bucket_size = 60
    cfg.align.min_aligned_marker_count = 20
    cfg.align.max_skip = 60
    cfg.align.max_drift = 60
    cfg.align.max_trim = 60
    cfg.read_graph.max_alignment_count = 8
    cfg.marker_graph.min_coverage = 3
    return cfg


def stage_hashes(run_dir):
    """tests/test_reference_parity.py:_stage_hashes."""
    from shasta_tpu_torch.data.store import RunStore

    store = RunStore(run_dir, create=False)
    out = {}
    for stage in sorted(store.stage_names()):
        h = hashlib.sha256()
        arrays = store.load_stage(stage)
        for name in sorted(arrays):
            a = np.ascontiguousarray(arrays[name])
            h.update(name.encode())
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        out[stage] = h.hexdigest()
    return out


def run_six(asm, fasta, times=None):
    steps = [
        ("addReads", lambda: asm.add_reads([fasta])),
        ("selectKmers", asm.select_kmers),
        ("findMarkers", asm.find_markers),
        ("flagPalindromicReads", asm.flag_palindromic_reads),
        ("findAlignmentCandidates", asm.find_alignment_candidates),
        ("computeAlignments", asm.compute_alignments),
    ]
    for name, fn in steps:
        t0 = time.perf_counter()
        fn()
        if asm.device.type == "cuda":
            torch.cuda.synchronize()
        if times is not None:
            times[name] = time.perf_counter() - t0


def phase_golden(work):
    from shasta_tpu_torch.pipeline.assemble import Assembler
    from shasta_tpu_torch.utils import synth

    genome = synth.random_genome(25000, seed=4242)
    reads = synth.sample_reads(genome, 130, 3000, seed=4243, both_strands=True)
    fasta = os.path.join(work, "golden.fasta")
    synth.write_fasta(fasta, reads)
    with open(GOLDEN) as f:
        pinned = json.load(f)
    got = {}
    for device in ("cuda", "cpu"):
        run_dir = os.path.join(work, f"golden-{device}")
        t0 = time.perf_counter()
        run_six(Assembler(run_dir, small_config(), device=device), fasta)
        got[device] = stage_hashes(run_dir)
        log(f"golden slice on {device}: {time.perf_counter() - t0:.2f}s")
    for stage in STAGES:
        if not (got["cuda"][stage] == got["cpu"][stage] == pinned[stage]):
            raise AssertionError(
                f"golden {stage}: cuda {got['cuda'][stage][:12]} cpu "
                f"{got['cpu'][stage][:12]} pinned {pinned[stage][:12]}"
            )
    log("golden slice: Reads, Kmers, Markers, AlignmentCandidates, Alignments "
        "hashes equal on card, CPU and pinned values")


def phase_real_size(work, sm_clock_mhz):
    from shasta_tpu_torch.ops import align as AL
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.pipeline.assemble import Assembler
    from shasta_tpu_torch.pipeline.config import AssemblyConfig
    from shasta_tpu_torch.pipeline.configurations import get_configuration
    from shasta_tpu_torch.utils import synth

    t0 = time.perf_counter()
    genome = synth.random_genome(5_000_000, seed=500)
    reads = synth.sample_reads_ont(
        genome, 25.0, seed=501, median_length=25000, sigma=0.55, min_length=3000
    )
    fasta = os.path.join(work, "ont5mb.fasta")
    synth.write_fasta(fasta, reads)
    log(
        f"real size: {len(reads)} reads, {sum(r.shape[0] for r in reads) / 1e6:.1f} Mb "
        f"generated in {time.perf_counter() - t0:.1f}s"
    )
    del reads
    cfg = AssemblyConfig.from_conf_text(get_configuration("Nanopore-May2022"))
    asm = Assembler(os.path.join(work, "ont5mb"), cfg, device="cuda")

    # The main path: counts to 0 just before, read just after.
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    K.TRACE = []
    torch.cuda.reset_peak_memory_stats()
    times = {}
    run_six(asm, fasta, times)
    launches = dict(K.LAUNCHES)
    trace, K.TRACE = K.TRACE, None
    peak = torch.cuda.max_memory_allocated()

    store = asm.alignments
    if not store.check_strictly_increasing():
        raise AssertionError("alignment ordinals not strictly increasing")
    by_shape, bounds = {}, {}
    for name, LA, W, B, rows, start, end in trace:
        e = by_shape.setdefault((name, LA, W), [0, 0, 0.0, 0, 0])
        e[0] += 1
        e[1] += B
        e[2] += start.elapsed_time(end)
        e[3] += int(rows.clamp(max=LA).sum()) * (W if name == "banded_fwd" else 1)
        e[4] += B * LA * W
    fwd_ms = sum(v[2] for (n, _, _), v in by_shape.items() if n == "banded_fwd")
    tb_ms = sum(v[2] for (n, _, _), v in by_shape.items() if n == "banded_tb")
    nominal = sum(v[4] for (n, _, _), v in by_shape.items() if n == "banded_fwd")
    real_cells = sum(v[3] for (n, _, _), v in by_shape.items() if n == "banded_fwd")
    log("real size stage seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))
    log(
        f"real size: reads {asm.reads.read_count}, candidates {asm.candidates.count}, "
        f"alignments {store.count}, palindromic {int(asm.reads.is_palindromic.sum())}, "
        f"max markers/oriented read {int(np.diff(asm.markers.offsets).max())}"
    )
    log(
        f"real size launches: {launches}; peak device memory "
        f"{peak / 2**30:.2f} GiB; kernel device time fwd {fwd_ms:.1f} ms, "
        f"tb {tb_ms:.1f} ms; card-side {nominal / ((fwd_ms + tb_ms) * 1e-3) / 1e9:.2f} "
        f"Gcells/s (B*LA*W), {real_cells / (fwd_ms * 1e-3) / 1e9:.2f} Gcells/s "
        f"of processed rows in banded_fwd"
    )
    dp_wall = times["flagPalindromicReads"] + times["computeAlignments"]
    log(
        f"real size: the two kernels are busy {(fwd_ms + tb_ms) / 1e3 / dp_wall:.1%} "
        f"of the wall time of the two stages that launch them ({dp_wall:.2f}s)"
    )
    for key, (n, B, ms, work, _nom) in sorted(by_shape.items()):
        name, LA, W = key
        bound, by, _ops_ms, _bytes_ms = class_bound(name, LA, W, B, work, sm_clock_mhz)
        bounds[key] = (bound, by)
        log(
            f"  {name} LA={LA} W={W}: {n} launches, {B} pairs, {ms:.2f} ms "
            f"(bound {bound:.4f} ms by {by}, {bound / ms:.1%})"
        )
    if launches["banded_fwd"] == 0 or launches["banded_tb"] == 0:
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    if not any(LA >= 8192 for (_n, LA, _w) in by_shape):
        raise AssertionError("no launch at LA >= 8192 on the main path")

    # Spot check: 256 seeded kept pairs plus the longest, re-aligned with
    # the plain version on the card; identical stores.
    rng = np.random.default_rng(7)
    longest = int(np.argmax(store.n_markers0 + store.n_markers1))
    pick = np.unique(
        np.concatenate([rng.choice(store.count, min(255, store.count), replace=False), [longest]])
    )
    # computeAlignments builds the same table (a hash of every one of the
    # 4^k k-mers) on the host before the alignment engine starts.
    ts = time.perf_counter()
    ds_table = asm.kmer_table.downsampling_hash_table()
    log(
        f"real size: downsampling hash table ({ds_table.shape[0]} k-mers) "
        f"built on the host in {time.perf_counter() - ts:.2f}s"
    )
    ts = time.perf_counter()
    real = K.banded_align_pairs
    K.banded_align_pairs = K.banded_align_pairs_plain
    try:
        sub = AL.align_candidates(
            asm.markers, store.read_id0[pick], store.read_id1[pick],
            store.same_strand[pick], _align_params(cfg), ds_table,
            device="cuda",
        )
    finally:
        K.banded_align_pairs = real
    if sub.count != pick.shape[0]:
        raise AssertionError(f"spot check kept {sub.count} of {pick.shape[0]}")
    for t, i in enumerate(pick):
        a0, a1 = store.ordinals(int(i))
        b0, b1 = sub.ordinals(t)
        if not (np.array_equal(a0, b0) and np.array_equal(a1, b1)):
            raise AssertionError(f"spot check: pair {i} differs from the plain version")
    log(
        f"spot check: {pick.shape[0]} kept pairs (longest {int(store.n_markers0[longest])}"
        f"+{int(store.n_markers1[longest])} markers) identical under the plain "
        f"version on the card ({time.perf_counter() - ts:.1f}s)"
    )
    return {
        "launches": launches, "times": times, "peak_bytes": peak,
        "reads": int(asm.reads.read_count), "candidates": int(asm.candidates.count),
        "alignments": int(store.count),
        "shapes": [
            {"kernel": n, "LA": LA, "W": W, "launches": v[0], "pairs": v[1],
             "device_ms": v[2], "work": v[3], "nominal_cells": v[4],
             "bound_ms": bounds[(n, LA, W)][0], "bound_by": bounds[(n, LA, W)][1]}
            for (n, LA, W), v in sorted(by_shape.items())
        ],
        "fwd_ms": fwd_ms, "tb_ms": tb_ms, "nominal_cells": nominal,
        "processed_cells": real_cells,
    }


def _align_params(cfg):
    from shasta_tpu_torch.ops.align import AlignParams

    ca = cfg.align
    return AlignParams(
        match_score=ca.match_score, mismatch_score=ca.mismatch_score,
        gap_score=ca.gap_score, downsampling_factor=ca.downsampling_factor,
        band_extend=ca.band_extend, max_band=ca.max_band,
        min_aligned_marker_count=ca.min_aligned_marker_count,
        min_aligned_fraction=ca.min_aligned_fraction, max_skip=ca.max_skip,
        max_drift=ca.max_drift, max_trim=ca.max_trim,
        suppress_containments=ca.suppress_containments,
    )


# ---------------------------------------------------------------------------


def main() -> int:
    t_start = time.perf_counter()
    sm_clock = phase_device_and_build()
    kernels = phase_kernels(sm_clock)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        phase_golden(work)
        real = phase_real_size(work, sm_clock)

    # The kernel line reports each kernel at the listed shape whose
    # class took the most banded_fwd time on the main path.
    fwd_ms = {
        (s["LA"], s["W"]): s["device_ms"]
        for s in real["shapes"] if s["kernel"] == "banded_fwd"
    }
    rep = max(kernels, key=lambda k: (fwd_ms.get(k, 0.0), k[0] * k[1]))
    r = kernels[rep]
    src = "shasta_tpu_torch/csrc/banded_align.cu"
    line = {"kernels": [
        {"name": "banded_fwd", "route": "cuda", "source": src,
         "replaces": "shasta_tpu/ops/align_pallas.py:156,581",
         "launches": real["launches"]["banded_fwd"], "max_abs_err": r["max_abs_err"],
         "ms": r["fwd_ms"], "plain_ms": r["fwd_plain_ms"],
         "bound_ms": r["fwd_bound_ms"], "bound_by": r["fwd_bound_by"],
         "library_ms": None, "shape": {"LA": rep[0], "W": rep[1], "B": r["B"]}},
        {"name": "banded_tb", "route": "cuda", "source": src,
         "replaces": "shasta_tpu/ops/align_pallas.py:296,714",
         "launches": real["launches"]["banded_tb"], "max_abs_err": r["max_abs_err"],
         "ms": r["tb_ms"], "plain_ms": r["tb_plain_ms"],
         "bound_ms": r["tb_bound_ms"], "bound_by": r["tb_bound_by"],
         "library_ms": None, "shape": {"LA": rep[0], "W": rep[1], "B": r["B"]}},
    ]}
    card = smi("name,power.limit")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(
            {"card": card, "sm_clock_mhz": sm_clock,
             "kernels": [dict(v) for v in kernels.values()], "real_size": real,
             "seconds": time.perf_counter() - t_start},
            f, indent=1,
        )
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
