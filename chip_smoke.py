"""Drive shasta_tpu_torch on one NVIDIA card and hold it to its references.

    python3 chip_smoke.py   # needs one CUDA device
    [SCALE=25 REGIME=ont] python3 chip_smoke.py --module scale_bench [--out FILE]

With no arguments it runs every phase below. With ``--module NAME`` it
runs one module of shasta_tpu_torch/benchmarks on the card instead, its
knobs (SCALE, REGIME, ITERATIVE, WAVES_AB_REPS) from the environment, and
records the run (record_module: wall and stage seconds, launches and
device ms by kernel class, class-matrix builds, peak device memory and
RSS, the FASTA files' sha256) to chiprun_out/.

Phases (any failure raises; the script then exits non-zero and prints
no result line):

1. Device and build: the card's name and power limit, then the CUDA
   kernels built from shasta_tpu_torch/csrc with nvcc (the native host
   library builds beside it, in parallel); ptxas's registers and spills
   (any spill of the anti-diagonal body or of the row-scan body fails),
   and the int32 instructions the anti-diagonal body issues per band
   cell (its SASS) at 1, 2 and 4 pairs per warp, which must be no fewer
   than the bound counts; the int32 instructions int32_chain's loop
   (csrc/int32_peak.cu) issues per element and iteration, which must be
   no fewer than the 8 operations its rate counts; the card's int32
   ceiling measured with int32_chain on a tile every SM gets an equal
   share of, against the data sheet's rate (64 lanes an SM) and the
   issue limit (128 lanes an SM, one warp instruction a cycle per
   sub-partition), which the bounds divide by: the ceiling must not
   pass it.
2. Kernels against their plain PyTorch version on the card, at the
   main path's (LA, W) classes, a phase-1 launch of 16,384 small pairs,
   odd widths, LA 1 and 17, phase-1-like full-matrix batches (LA 128 x
   W 512 and 512 x 2048), bands wider than one block holds, which the
   row-scan body runs on thread-block clusters (LA 512 x W 20480, a band
   sliding across LA = LB = 24576 at W 20480, and 256 x 40000, past one
   cluster, in two strips),
   the edge-case, long-gap and mixed-length batches: exact int32
   equality of each kernel's output and of the fused (B, 16 + LA)
   result, and of match_compact's CSR (every other row kept, uint16 and
   uint32) at each of those shapes. banded_fwd runs both its bodies where W <= DIAG_W_LIMIT
   (the anti-diagonal body and the row-scan body, timed in turns in this
   call), banded_fwd_waves runs at waves 2 and 4 wherever fwd_kernel
   gives it (the anti-diagonal body's shapes up to W 2048); times, Gcells/s, the nominal and the
   in-matrix cells, and the least time the card could take (the bound:
   the in-matrix cells' int32 operations, or the inputs and every dirs
   word of a processed row); any time below its bound fails. Then both
   forward bodies and the waves kernel at 1 to 16 blocks per SM. Then
   kmer_table (csrc/kmer_table.cu): the k-14 downsampling hash table
   (2^28 ids) built through data/kmers.py's card path, equal bit for bit
   (sha256 of all 1 GiB, and a stride of ids against the numpy hash) to
   the numpy table the spot-check worker builds; its time against its
   bound (4 bytes written an id).
3. The golden input (tests/golden/mode0_stage_hashes.json's) through the
   whole assemble command (shasta_tpu_torch.__main__.main) on the card,
   on the card with SHASTA_TORCH_WAVES=2 and =4, and on the CPU: all
   eight stage hashes equal the pinned values, the summary's counts
   equal tests/golden/mode0_metrics.json, and the FASTA and GFA files
   are byte-equal across the four runs. Then the palindrome pass at
   deltaThreshold 8200 (a band of 16400 lanes, the W 32768 class) on the
   golden input's first 32 reads and a palindromic read, on the card and
   on the CPU: equal flags, the palindromic read flagged, every card
   launch in that class on the row-scan body (the launch trace).
4. Mode 0 end to end at a real size on the card (run_assembly): a 5 Mb
   random genome, ONT-like reads at 25x, Nanopore-May2022 verbatim. The
   launch counts are reset just before the run and read just after, and
   the launch trace must show every banded_fwd class on the body
   fwd_body picks, the W 128 and 512 classes with LA >= W / 2 on the
   anti-diagonal body; 128 kept pairs are re-aligned with the plain
   version on the card and must agree. Then computeAlignments runs
   again on the run's own Markers and AlignmentCandidates with
   SHASTA_TORCH_WAVES=2 (the waves kernel's main path): it gives the
   run's Alignments hash, and each class's forward time prints beside
   that of the run's own computeAlignments, with its pairs per launch.
   Assembly.fasta is graded against the genome (utils/accuracy.py:
   k-mer QV, completeness, misassemblies).
5. Mode 2 golden: tests/test_reference_parity.py:_golden_run_mode2's
   input and configuration through the assemble command on the card, on
   the card with SHASTA_TORCH_WAVES=2 and on the CPU: all 17 values of
   tests/golden/mode2_stage_hashes.json (8 stage manifests, 9 output
   files) equal the pinned ones in each run.
6. Mode 2 at a real size on the card (run_assembly): two 2 Mb haplotypes
   (cut from 5 Mb to keep the script inside its time limit on a slow
   host; a random genome, seed 600, and a copy with one substitution every
   1,000 bases at a seeded jitter, seed 601), ONT-like reads at 15x on
   each (seeds 602 and 603, phase 4's length model),
   Nanopore-Phased-May2022 verbatim. Launch counts reset just before the
   run and read just after; the stages, counts, bubbles, phased bubbles
   and the Phased and Haploid FASTA's length and N50 print, with the
   kernels' classes; 128 kept pairs re-aligned with the plain version on
   the card must agree. It fails if no bubble is phased or
   Assembly-Phased.fasta is empty. Assembly-Phased.fasta is graded
   against the two haplotypes (phasing purity, het k-mer recall, switch
   errors), Assembly-Haploid.fasta with both as the truth.
7. Alignment method 4 and iterative assembly: (a) the mode-0 golden input
   under --Align.alignMethod 4 on the card and on the CPU (equal
   Alignments manifests, byte-equal FASTA/GFA); (b) method 4 on the first
   2,048 candidates of phase 4's run, on its Markers, with the host time
   of align4_bands apart from the kernels', and 128 of its tasks
   re-aligned with the plain version on the card; (c) iterative assembly
   on tests/test_iterative.py's input on the card and on the CPU (every
   stage manifest and the FASTA/GFA equal). Methods 0 and 1 run on the
   host only and are left to the CPU tests.
8. Mode 3: (a) tests/test_torch_mode3.py's seed-55/56 input and its 2%
   error input (the one whose Jaccard graph has paths) through the
   assemble command on the card and on the CPU: every stage manifest,
   the three mode-3 files, write_output's files and the eight mode3*
   values equal; (b) a 1 Mb random genome (seed 700), ONT-like reads at 25x
   (seed 701), Nanopore-May2022 verbatim plus --Assembly.mode 3, the
   whole run_assembly on the card: launch counts reset just before and
   read just after, 128 kept pairs re-aligned with the plain version on
   the card, Mode3-Paths.fasta graded against the genome; it fails if no
   Jaccard path is assembled.
9. The mesh (shasta_tpu_torch/parallel), in ranks that
   parallel.distributed.spawn starts: (a) every sharded function on a
   one-rank NCCL world on the card against its host function on seeded
   inputs (the plain DP on the card for the alignment wrappers), then
   entry.dryrun_multichip(1); (b) run_assembly_distributed on two gloo
   ranks that share the card, on the golden inputs of modes 0 and 2:
   every golden value in both ranks' run directories, mode 0's FASTA and
   GFA byte-equal to phase 3's; (c) phase 4's 5 Mb run under
   Nanopore-May2022 on two gloo ranks that share the card: Assembly.fasta
   and Assembly.gfa byte-equal to phase 4's. Each rank prints its stage
   seconds, launches by class, kernels' device time, peak device memory
   and the exchange's seconds (all_to_all, MIN rounds, gathers); launch
   counts start from 0 in each rank, which must launch both kernels.
10. The explorer on the card (http/explore.py) over phase 3's golden run
   and phase 8a's noisy mode-3 run: tests/test_cli.py's pages and the
   mode-3 pages answer 200, and the on-demand alignment of a stored
   alignment's reads launches the kernels.

11. The stage drivers (shasta_tpu_torch/scripts), each run in this
   process through its main(argv), launch counts from 0 just before it:
   (a) on two copies of phase 3's golden run, one on the card and one
   with --device cpu, ComputeAlignments.py (on the card also under
   SHASTA_TORCH_WAVES=2), FlagPalindromicReads.py,
   FindAlignmentCandidatesLowHash0.py, AlignOrientedReads.py and
   AlignOrientedReads4.py on the first stored alignment's reads,
   Mode0Assembly.py and Test.py: the stages they rewrite keep the pinned
   hashes, the card's output equals the CPU's, each card run of a
   DP-running driver launched the forward and traceback kernels (the
   waves kernel under waves 2 only), and Assembly.fasta and Assembly.gfa
   are byte-equal to phase 3's; FlagPalindromicReads.py then runs again
   as a file in a shell, on the card by default; (b) ComputeAlignments.py
   and FlagPalindromicReads.py on the card on phase 4's 5 Mb run: the
   Alignments and Reads hashes equal phase 4's, ComputeAlignments.py's
   launches by (LA, W) class (LA >= 8192 among them; the palindrome
   pass's host prefilter leaves FlagPalindromicReads.py no read to align
   there, as in phase 4's run), the kernels' device time and each
   driver's wall seconds.
12. The bench entry point: python -m shasta_tpu_torch.bench --reps 3 at
   bench.py's workload in a process of its own: its last stdout line has
   bench.py's 12 keys, finite values, value and the Gcells rates above 0
   and kernel_pct_peak at 105 or below; its launches (stderr) are the
   "bench" path. Then in this process: every kernel of the roofline
   batch (B 1024 x LA 512 x W 128; banded_fwd_waves at waves 2 and 4)
   equal to the plain version bit for bit; int32_chain equal to
   its plain version modulo 2**32 (K 256 on the bench's tile; K 1, 2, 5
   over the whole int32 range), timed; two reps of the bench's
   align_candidates and one under a one-rank NCCL mesh give equal
   AlignmentStores; 128 kept pairs re-aligned with the plain version.
13. The scale and A/B modules (shasta_tpu_torch/benchmarks), each through
   its main(argv) in this process, launch counts from 0 just before it:
   scale_bench at SCALE=1 under both regimes, mode2_scale_bench at
   SCALE=1 uniform1, waves_ab at WAVES_AB_REPS=2 and mode2_phase_exp at a
   500 kb genome (its SIZE constant cut) with two of its four
   configurations (its CONFIGS cut). Each assembly run must launch banded_fwd
   and banded_tb (not banded_fwd_waves), print its graded summary and
   leave non-empty FASTA files; waves_ab must launch banded_fwd_waves
   (every variant's chain equal to waves 1's). Then scale_bench's reads
   at SCALE=5 REGIME=ont must hash equal to phase 4's FASTA.

The spot checks of phases 4, 6 and 8 (128 kept pairs re-aligned with
the plain version on the card, from the run directory's stored stages)
run in one spawned worker process beside the phases that follow; the
script collects them after phase 10 and fails on any. Phase 11 runs
after that, since it rewrites stages of those runs.

The grades record accuracy and gate nothing: no floor has been measured.

Each phase's seconds print. The line before the last is
{"kernels": [...]}, each kernel's launches summed over the paths that
ran it (``paths``: the runs of phases 4 to 13, the mesh's ranks, the
explorer, the stage drivers, the bench and the benchmarks modules included; int32_chain, the
bench's int32 ceiling, on the bench's path only); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
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
GOLDEN_METRICS = os.path.join(ROOT, "tests", "golden", "mode0_metrics.json")
GOLDEN_MODE2 = os.path.join(ROOT, "tests", "golden", "mode2_stage_hashes.json")
STAGES = [
    "Reads", "Kmers", "Markers", "AlignmentCandidates", "Alignments",
    "ReadGraph", "MarkerGraph", "AssemblyGraph",
]
OUTPUTS = ["Assembly.fasta", "Assembly.gfa", "Assembly-BothStrands.gfa"]
# tests/test_reference_parity.py:MODE0_FILE_FAMILY and GOLDEN_KEYS.
MODE0_FILE_FAMILY = [
    "Assembly.fasta", "Assembly.gfa", "Assembly-BothStrands.gfa",
    "AssemblySummary.html", "AssemblySummary.json", "index.html",
    "shasta.conf", "performance.log", "stdout.log", "ReadLengthHistogram.csv",
]
GOLDEN_KEYS = [
    "readCount", "rawBaseCount", "rleBaseCount", "markerCount",
    "alignmentCandidateCount", "alignmentCount", "chimericReadCount",
    "palindromicReadCount", "markerGraphVertexCount", "markerGraphEdgeCount",
    "assembledSegmentCount", "totalAssembledSegmentLength",
    "longestAssembledSegmentLength", "assembledSegmentN50",
]
WAVES = (2, 4)
SCORES = dict(match=6, mismatch=-1, gap=-1)
# (LA = LB, W, pairs, batch): phase 1's class, the phase-2 classes (4096
# x 128 takes the most kernel time on the real-size run), a wide band,
# the ultra-long classes, a phase-1 launch at _batch_plan's 16,384 pairs,
# a band past 4096 lanes (which a max_band above 2047 reaches), widths
# that are not a multiple of 32 (the anti-diagonal body's phantom lanes
# at K = 2, 16, 16; the row-scan body just past 2048), LA 1 and 17,
# W = LA and W = 2 LA, and W past DIAG_MAX_W at W <= 2 LA (where
# fwd_body's crossover lies), all "make" (make_batch); phase-1-like
# batches ("full": full_batch, lengths below LA and the full-matrix
# band); and bands wider than one block holds, on the row-scan body's
# clusters (40000 in two strips): "wide" (wide_batch, paths across lane
# 16384) and "sliding" (sliding_batch, LA = LB = 24576, W 20480,
# band_min = -W / 2: 2 pairs, about 115 ms on the card and 10 s for the
# plain version, within the script's time).
SHAPES = [
    (128, 512, 2048, "make"), (2048, 128, 512, "make"), (4096, 512, 256, "make"),
    (1024, 2048, 128, "make"), (4096, 128, 256, "make"), (8192, 512, 64, "make"),
    (32768, 128, 64, "make"), (512, 8192, 8, "make"), (1024, 33, 256, "make"),
    (1024, 288, 256, "make"), (2048, 511, 128, "make"), (512, 2049, 32, "make"),
    (1, 128, 64, "make"), (17, 512, 64, "make"), (256, 128, 16384, "make"),
    (1024, 1024, 128, "make"), (512, 1024, 128, "make"), (2048, 4096, 32, "make"),
    (4096, 2049, 64, "make"),
    (128, 512, 2048, "full"), (512, 2048, 512, "full"),
    (512, 20480, 4, "wide"), (256, 40000, 4, "wide"), (24576, 20480, 2, "sliding"),
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TB_OPS_PER_ROW = 12  # banded_tb_kernel's int32 work per walked row


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def phase_device_and_build():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from shasta_tpu_torch import native
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.utils import peak

    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"nvidia-smi: {peak.nvidia_smi('name,power.limit')}")
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}"
    )
    native_err = []

    def build_native():
        try:
            native.get_lib()
        except RuntimeError as e:
            native_err.append(e)

    t = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    t.start()
    nvcc_s = K.build_kernels(force=True)
    t.join()
    if native_err:
        raise native_err[0]
    log(
        f"build: nvcc {nvcc_s:.2f}s ("
        + ", ".join(os.path.basename(c) for c in K.kernel_sources()[0])
        + f", one nvcc each, sm_90a); native host library ok; "
        f"wall {time.perf_counter() - t0:.2f}s"
    )
    ptxas = {}
    for src, report in K.PTXAS_REPORT.items():
        fn = None
        for ln in report.splitlines():
            m = re.search(
                r"Compiling entry function '.*?(banded_[a-z_]+kernel|int32_chain_kernel)(\w*)'",
                ln,
            )
            if m:
                fn = m.group(1) + "<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) + ">"
            elif fn and ("registers" in ln or "spill" in ln):
                log(f"ptxas {src} {fn}: {ln.split(':', 1)[-1].strip()}")
                e = ptxas.setdefault(f"{src} {fn}", {})
                if r := re.search(r"Used (\d+) registers", ln):
                    e["registers"] = int(r.group(1))
                if r := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
                    e["spill_bytes"] = int(r.group(1)) + int(r.group(2))
    sass = {}
    for P in (1, 2, 4):
        sass[P] = diag_sass_ops_per_cell(P)
        log(
            f"sass banded_fwd_diag_kernel<4,false,{P}>: {sass[P]['per_cell']:.2f} int32 "
            f"instructions issued per band cell ({sass[P]['int_ops']} per pair step of "
            f"{4 * P} cells: {sass[P]['by_opcode']}); the bound counts "
            f"{K.FWD_INT_OPS_PER_CELL}"
        )
        if sass[P]["per_cell"] < K.FWD_INT_OPS_PER_CELL:
            raise AssertionError(
                "the anti-diagonal body issues fewer int32 instructions per cell than "
                "FWD_INT_OPS_PER_CELL: the bound is not a lower bound"
            )
    spilled = [
        k for k, e in ptxas.items()
        if ("banded_fwd_diag.cu" in k or "banded_align.cu" in k) and e.get("spill_bytes")
    ]
    if spilled:
        raise AssertionError(f"a forward body spills registers: {spilled}")
    if not any("banded_align.cu" in k for k in ptxas):
        raise AssertionError("no ptxas report of the row-scan body's kernels")
    chain_sass = int32_chain_sass()
    log(
        f"sass int32_chain_kernel: {chain_sass['per_iteration']} int32 instructions issued "
        f"per element and iteration against {peak.OPS_PER_ITERATION} source operations "
        f"(loop unrolled {chain_sass['unrolled']}x: {chain_sass['by_opcode']})"
    )
    if chain_sass["per_iteration"] < peak.OPS_PER_ITERATION:
        raise AssertionError(
            "int32_chain issues fewer int32 instructions per iteration than the operations "
            "its rate counts: its bound is not a lower bound"
        )
    sm_clock_mhz = float(peak.nvidia_smi("clocks.max.sm").split()[0])
    ceiling = int32_ceiling(sm_clock_mhz)
    return sm_clock_mhz, {"sass": sass, "ptxas": ptxas, "int32_chain_sass": chain_sass,
                          "int32_ceiling": ceiling}


def int32_ceiling(sm_clock_mhz):
    """The card's int32 rate measured with int32_chain (bench.py's chain),
    on a tile of SMs x 2048 x 4 elements (one element a thread: four
    full-occupancy waves, an equal share for every SM; bench.py's
    (1024, 512) tile gives each SM sub-partition 31.03 warps, so the
    slowest run 32), K 8448 against K 256, best of 3, against the data
    sheet's rate and the issue limit. Fails when it passes the issue
    limit, which bound_ms divides by."""
    from shasta_tpu_torch.utils import peak

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = sms * 2048 * 4
    x = torch.from_numpy(
        np.random.default_rng(23).integers(-1000, 1000, n).astype(np.int32)
    ).cuda()
    K0, K1 = 256, 8448

    def rate():
        ms = [cuda_ms(lambda K=K: peak.int32_chain(x, K), 1) for K in (K0, K1)]
        return n * peak.OPS_PER_ITERATION * (K1 - K0) / ((ms[1] - ms[0]) / 1e3)

    measured = max(rate() for _ in range(3))
    sheet = peak.data_sheet_int32_ops(sm_clock_mhz, sms)
    issue = peak.issue_limit_ops(sm_clock_mhz, sms)
    log(
        f"int32 ceiling: {measured / 1e9} Gops/s on {n} elements ({sms} SMs x 2048 x 4): "
        f"{measured / sheet} times the data sheet's {sheet / 1e9} Gops/s "
        f"({sms} x {peak.INT32_LANES_PER_SM} x {sm_clock_mhz:.0f} MHz), {measured / issue} "
        f"of the issue limit's {issue / 1e9} ({sms} x {peak.ISSUE_LANES_PER_SM} x "
        f"{sm_clock_mhz:.0f} MHz), which the bounds divide by"
    )
    if measured > issue:
        raise AssertionError("the int32 ceiling passes the issue limit: no bound is a lower bound")
    return {"measured_ops_per_s": measured, "data_sheet_ops_per_s": sheet,
            "issue_limit_ops_per_s": issue, "ratio": measured / sheet,
            "share_of_issue_limit": measured / issue, "elements": n}


# SASS opcodes left out of a count of issued int32 operations: memory,
# control and shuffles (uniform-datapath U* opcodes are left out too).
NOT_INT_OPS = {
    "SHFL", "BRA", "BSSY", "BSYNC", "STG", "LDG", "LDC", "LDS", "STS", "BAR",
    "NOP", "EXIT", "WARPSYNC",
}


def kernel_sass(name):
    """(address, instruction) of the first function of the built library
    whose mangled name holds ``name``, from cuobjdump -sass, predicates
    stripped."""
    from shasta_tpu_torch.ops import align_kernel as K

    tool = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [tool, "-sass", K.LIBRARY_PATH], capture_output=True, text=True, check=True
    ).stdout
    fn = next(f for f in sass.split("Function : ")[1:] if name in f.split("\n", 1)[0])
    return [
        (int(a, 16), re.sub(r"^@!?U?P[T\d]+\s+", "", x.strip()))
        for a, x in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)
    ]


def int32_op_counts(instructions):
    """The count of each int32 arithmetic opcode among ``instructions``
    (SASS text), most frequent first; NOT_INT_OPS and U* opcodes left out."""
    ops = [x.split()[0].split(".")[0] for x in instructions]
    ops = [o for o in ops if o not in NOT_INT_OPS and not o.startswith("U")]
    return {o: ops.count(o) for o in sorted(set(ops), key=ops.count, reverse=True)}


def int32_chain_sass():
    """The int32 instructions int32_chain_kernel issues per element and
    iteration: its unrolled loop (the backward branch whose body holds
    the most copies of the chain's xor constant), by int32_op_counts,
    divided by those copies."""
    ins = kernel_sass("int32_chain_kernel")
    branches = [
        (int(m.group(1), 16), a) for a, x in ins
        if (m := re.search(r"BRA(?:\.\w+)* (?:U?!?P\w+, )?0x([0-9a-f]+)", x))
    ]
    loops = [(t, a) for t, a in branches if t < a]
    if not loops:
        raise RuntimeError("int32_chain_sass: no loop in int32_chain_kernel's SASS")

    def body(lo, hi):
        return [x for a, x in ins if lo <= a <= hi]

    lo, hi = max(loops, key=lambda r: sum("0x9e3779b9" in x for x in body(*r)))
    copies = sum("0x9e3779b9" in x for x in body(lo, hi))
    if copies == 0:
        raise RuntimeError("int32_chain_sass: the chain's xor constant is not in its loop")
    by_opcode = int32_op_counts(body(lo, hi))
    return {"per_iteration": sum(by_opcode.values()) / copies, "unrolled": copies,
            "by_opcode": by_opcode}


def diag_sass_ops_per_cell(P):
    """The int32 instructions banded_fwd_diag_kernel<4, false, P> (one
    warp, W 65 to 128, P pairs) issues per band cell, from cuobjdump -sass
    of the built library: its pair-step loop (the backward branch around
    the input slide's SHFL.IDX; 4 cells per thread and pair), without the
    regions a forward branch inside it skips (the 16-row flush stores)
    and without the opcodes int32_op_counts leaves out."""
    ins = kernel_sass(f"banded_fwd_diag_kernelILi4ELb0ELi{P}E")
    branches = [
        (a, int(m.group(1), 16)) for a, x in ins
        if (m := re.search(r"BRA (?:P\d, )?0x([0-9a-f]+)", x))
    ]
    lo, hi = next(
        (t, a) for a, t in branches
        if t < a and any(x.startswith("SHFL.IDX") for b, x in ins if t <= b <= a)
    )
    skipped = {
        b for a, t in branches if lo <= a < t <= hi for b, _ in ins if a < b < t
    }
    by_opcode = int32_op_counts(
        x for a, x in ins if lo <= a <= hi and a not in skipped
    )
    n = sum(by_opcode.values())
    return {"int_ops": n, "per_cell": n / (4 * P), "by_opcode": by_opcode}


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


def edge_batch(LA, W):
    """tests/test_torch_align_kernel.py::test_edge_cases_match_pallas_interpret's
    batch: empty pairs, length-1 sequences, bands at both clamp limits,
    a full-length identical pair and padding rows."""
    B = 8
    rng = np.random.default_rng(9)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LA), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    g = rng.integers(0, 30, 300).astype(np.int32)
    b[0, :50] = g[:50]
    b_len[0] = 50
    a[1, :50] = g[:50]
    a_len[1] = 50
    a[2, 0] = b[2, 0] = 7
    a_len[2] = b_len[2] = 1
    for t, band in ((3, -(LA + W)), (4, LA)):
        a[t, :60] = b[t, :60] = g[:60]
        a_len[t] = b_len[t] = 60
        bm[t] = band
    a[5] = b[5] = g[:LA]
    a_len[5] = b_len[5] = LA
    return a, a_len, b, b_len, bm


def gap_batch(LA, W, seed=11):
    """tests/torch_common.py:gap_batch: pairs with 40- and 70-long gaps,
    whose traceback paths cross 32-lane chunks of the band both ways."""
    rng = np.random.default_rng(seed)
    B = 8
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LA), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    n = LA - 80
    for t in range(B):
        L = (40, 70)[t % 2]
        g = rng.integers(0, 1000, n).astype(np.int32)
        ins = rng.integers(1000, 2000, L).astype(np.int32)
        cut = n // 3 + 7 * t
        long_ = np.concatenate([g[:cut], ins, g[cut:]])
        if t < B // 2:
            a[t, :n], b[t, : n + L] = g, long_
            a_len[t], b_len[t] = n, n + L
            bm[t] = -(W // 8) - (t % 3)
        else:
            a[t, : n + L], b[t, :n] = long_, g
            a_len[t], b_len[t] = n + L, n
            bm[t] = -L - (W // 8) + (t % 3)
    return a, a_len, b, b_len, bm


def mixed_batch(LA, W, B=13, seed=21):
    """tests/torch_common.py:mixed_batch: pairs of very different lengths
    side by side (a_len 0, 1, 2, 17, LA // 2, LA, LA + 40; b_len within 5
    of it), as the waves kernel puts them in one warp."""
    rng = np.random.default_rng(seed)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LA), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    cycle = [0, 1, 2, 17, LA // 2, LA, LA + 40]
    for t in range(B):
        g = rng.integers(0, 50, 2 * LA).astype(np.int32)
        la = cycle[t % len(cycle)]
        lb = min(LA, max(1, la + int(rng.integers(-5, 6))))
        n = min(la, LA)
        a[t, :n] = g[:n]
        b[t, :lb] = g[:lb]
        sub = rng.random(n) < 0.1
        a[t, :n][sub] = rng.integers(0, 50, int(sub.sum()))
        a_len[t], b_len[t] = la, lb
        bm[t] = -(W // 2) + int(rng.integers(-(W // 8), W // 8 + 1))
    return a, a_len, b, b_len, bm


def wide_batch(LA, W, B, seed=31):
    """tests/torch_common.py:wide_batch: a band past 16384 lanes, b of
    W + LA so that every lane lies inside the matrix on some row, each
    path crossing a multiple of 16384 lanes by a run of LEFT moves; odd
    pairs end on b's last column."""
    LB = W + LA
    rng = np.random.default_rng(seed)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LB), -2, np.int32)
    a_len = np.full(B, LA, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    n_edges = max(1, (W - 1) // 16384)
    for t in range(B):
        edge = 16384 * (1 + (t // 2) % n_edges)
        L = max(2, min(LA // 2, 2 * (W - edge) - 8))
        c = edge - L // 2
        cut = LA // 2
        x = rng.integers(0, 50, LA).astype(np.int32)
        bg = rng.integers(0, 50, LB).astype(np.int32)
        bg[c : c + cut] = x[:cut]
        bg[c + cut + L : c + L + LA] = x[cut:]
        sub = rng.random(LA) < 0.1
        x[sub] = rng.integers(0, 50, int(sub.sum()))
        a[t] = x
        b_len[t] = LB if t % 2 == 0 else c + L + LA - 3
        b[t, : b_len[t]] = bg[: b_len[t]]
        bm[t] = -(t % 3)
    return a, a_len, b, b_len, bm


def full_batch(LA, W, B, seed=41, alpha=1000):
    """Phase-1-like pairs (ops/align.py, method 3's first phase): lengths
    uniform in [LA / 4, LA], the full-matrix band j - i in [-la, lb]
    centred in W as the align engine centres it (band_min = -la -
    (W - la - lb - 1) // 2), b a shifted copy of a with ~8% random
    substitutions; one pair with b_len = LA."""
    rng = np.random.default_rng(seed)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LA), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    for t in range(B):
        la = int(rng.integers(max(1, LA // 4), LA + 1))
        lb = LA if t == 0 else int(rng.integers(max(1, LA // 4), LA + 1))
        g = rng.integers(0, alpha, la + lb + 16).astype(np.int32)
        sh = int(rng.integers(0, 16))
        a[t, :la] = g[:la]
        b[t, :lb] = g[sh : sh + lb]
        sub = rng.random(lb) < 0.08
        b[t, :lb][sub] = rng.integers(0, alpha, int(sub.sum()))
        a_len[t], b_len[t] = la, lb
        bm[t] = -la - max(0, W - la - lb - 1) // 2
    return a, a_len, b, b_len, bm


def sliding_batch(LA, W, B, seed=51, alpha=1000):
    """Pairs of LA = LB markers in a band of W < LA lanes centred on the
    diagonal (band_min = -W / 2): the live window slides one column a
    row across the whole of b; b is a copy of a shifted by up to W / 8
    with ~8% random substitutions."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, alpha, (B, LA)).astype(np.int32)
    b = np.full((B, LA), -2, np.int32)
    for t in range(B):
        sh = int(rng.integers(0, W // 8))
        b[t, sh:] = a[t, : LA - sh]
        sub = rng.random(LA) < 0.08
        b[t][sub] = rng.integers(0, alpha, int(sub.sum()))
    full = np.full(B, LA, np.int32)
    return a, full, b, full.copy(), np.full(B, -(W // 2), np.int32)


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
    operations over the card's issue limit at the SM clock (peak.py:
    128 lanes an SM; phase 1 checks that the anti-diagonal body and
    int32_chain issue no fewer instructions than their bounds count
    operations, and that the measured int32 ceiling stays below it), and
    bytes over the HBM rate."""
    from shasta_tpu_torch.utils import peak

    issue = peak.issue_limit_ops(
        sm_clock_mhz, torch.cuda.get_device_properties(0).multi_processor_count
    )
    t_ops = ops / issue * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, t_ops, t_bytes


def fwd_work(a_len, b_len, band_min, LA, LB, W):
    """What a forward launch must do on these inputs: (in-matrix cells,
    nominal cells, bytes). The in-matrix cells (0 <= j <= b_len on
    processed rows, in_matrix_cells) are the ones whose int32 operations
    the bound counts; the nominal cells are the band's, rows x W; the
    bytes are the inputs read once and every dirs word of a processed
    row written once."""
    from shasta_tpu_torch.ops import align_kernel as K

    B = a_len.shape[0]
    rows = a_len.clamp(max=LA).to(torch.int64)
    words = int(((rows + 15) // 16).sum()) * W
    cells = K.in_matrix_cells(a_len, b_len, band_min, LA=LA, W=W)
    return cells, int(rows.sum()) * W, 4 * B * (LA + LB) + 4 * 5 * B + 4 * words


def check_shares(label, bound, times):
    """Fails when a kernel's time is below its bound (a share past 100 %:
    the bound undercounts the work)."""
    over = {k: v for k, v in times.items() if v is not None and bound / v > 1.0}
    if over:
        raise AssertionError(f"{label}: time below the bound {bound:.4f} ms: {over}")


def check_kernels(host, LA, W, plain=None, pmj=None):
    """Every kernel against the plain version on one batch: banded_fwd
    (each body that takes W) on every dirs word of a processed row and
    on best, bi and bd; banded_tb on the plain dirs; the fused output;
    banded_fwd_waves (waves 2 and 4, where fwd_kernel gives it)
    followed by banded_tb. ``plain`` and ``pmj``: the plain version's
    forward and traceback outputs on these inputs, when the caller has
    them. Returns (device inputs, plain forward, plain fused, max error)."""
    from shasta_tpu_torch.ops import align_kernel as K

    LB = host[2].shape[1]
    kw = dict(LA=LA, LB=LB, W=W, **SCORES)
    dev = [torch.from_numpy(x).cuda() for x in host]
    a, a_len, b, b_len, bm = K.prepare_inputs(*dev, LA=LA, LB=LB, W=W)
    if plain is None:
        plain = K.banded_fwd_plain(a, a_len, b, b_len, bm, **kw)
    pdirs, pbest, pbi, pbd = plain
    if pmj is None:
        pmj = K.banded_tb_plain(pdirs, pbi, pbd, bm, LA=LA, W=W)
    pfused = torch.cat([K.metrics_from_mj(pmj, pbest), pmj], dim=1)
    words = (torch.arange(K.n_words(LA), device="cuda")[None, :] * 16) < a_len[:, None]

    def fwd_err(out):
        dirs, best, bi, bd = out
        return max(
            int((best - pbest).abs().max()), int((bi - pbi).abs().max()),
            int((bd - pbd).abs().max()),
            int(((dirs != pdirs) & words[:, :, None]).sum()),
        )

    errs = {}
    for body in ("diag", "rows") if W <= K.DIAG_W_LIMIT else ("rows",):
        errs[f"fwd {body}"] = fwd_err(K._banded_fwd_body(body, a, a_len, b, b_len, bm, **kw))
    errs["tb"] = int((K.banded_tb(pdirs, pbi, pbd, bm, LA=LA, W=W) - pmj).abs().max())
    errs["fused"] = int((K.banded_align_pairs(*dev, **kw) - pfused).abs().max())
    for w in WAVES if K.fwd_kernel(LA, W, 2) == "banded_fwd_waves" else ():
        errs[f"waves {w}"] = max(
            fwd_err(K.banded_fwd_waves(a, a_len, b, b_len, bm, waves=w, **kw)),
            int((K.banded_align_pairs(*dev, waves=w, **kw) - pfused).abs().max()),
        )
    torch.cuda.synchronize()
    bad = {k: v for k, v in errs.items() if v}
    if bad:
        raise AssertionError(f"kernel != plain at LA={LA} W={W}: {bad}")
    return (a, a_len, b, b_len, bm), plain, pfused, max(errs.values())


def check_match_compact(fused):
    """match_compact against its plain version on a fused batch on the
    card, every other row kept, at uint16 (int16 storage) and uint32
    (int32) output."""
    from shasta_tpu_torch.ops import align_kernel as K

    kept = torch.arange(fused.shape[0], device=fused.device) % 2 == 0
    cnt = torch.where(kept, fused[:, 0].to(torch.int64), 0)
    dst = torch.where(kept, torch.cumsum(cnt, 0) - cnt, -1)
    n = int(cnt.sum())
    for dt in (torch.int16, torch.int32):
        got = [torch.zeros(n, dtype=dt, device=fused.device) for _ in range(2)]
        ref = [torch.zeros(n, dtype=dt, device=fused.device) for _ in range(2)]
        K.match_compact(fused, dst, *got)
        K.match_compact_plain(fused, dst, *ref)
        torch.cuda.synchronize()
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"match_compact != plain ({dt}) at {tuple(fused.shape)}")


def phase_kernels(sm_clock_mhz):
    from shasta_tpu_torch.ops import align_kernel as K

    for W in (128, 512):
        check_kernels(edge_batch(128, W), 128, W)
        check_kernels(gap_batch(256, W), 256, W)
        log(f"edge-case and long-gap batches at W={W}: every kernel equal to the plain version")
    check_kernels(edge_batch(256, 512), 256, 512)
    for LA, W in ((128, 33), (128, 128), (256, 512), (1024, 2048)):
        check_kernels(mixed_batch(LA, W), LA, W)
    log(
        "edge-case batch at LA 256 x W 512 and mixed-length batches (a_len 0 to "
        "LA + 40 in one warp, 13 pairs) at 128 x 33, 128 x 128, 256 x 512, "
        "1024 x 2048: every kernel equal to the plain version, banded_fwd_waves "
        "at waves 2 and 4 included"
    )
    results = {}
    batches = {"make": lambda LA, W, B: make_batch(LA * 7 + W, B, LA, W),
               "full": lambda LA, W, B: full_batch(LA, W, B, seed=LA + W),
               "wide": wide_batch, "sliding": sliding_batch}
    for LA, W, B, kind in SHAPES:
        host = batches[kind](LA, W, B)
        LB = host[2].shape[1]
        kw = dict(LA=LA, LB=LB, W=W, **SCORES)
        plan = K.rows_plan(LA, LB, W)
        # The plain version once, timed (forward, then traceback); the
        # kernels are held to these outputs.
        dev = [torch.from_numpy(x).cuda() for x in host]
        a, a_len, b, b_len, bm = K.prepare_inputs(*dev, LA=LA, LB=LB, W=W)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = K.banded_fwd_plain(a, a_len, b, b_len, bm, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pmj = K.banded_tb_plain(plain[0], plain[2], plain[3], bm, LA=LA, W=W)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, _, pfused, max_err = check_kernels(host, LA, W, plain, pmj)
        del plain, pmj
        n_matched = int(pfused[:, 0].sum())
        if n_matched == 0 and LA > 1:
            raise AssertionError(f"no matches at LA={LA} W={W}: a vacuous check")
        check_match_compact(pfused)

        # Times: the anti-diagonal body (where it takes W) and the
        # row-scan body in turns (rows, diag, diag, rows), the traceback,
        # the waves kernel. fwd_ms is the body banded_fwd picks.
        reps = 20 if LA * W <= 1 << 20 else 5
        body = K.fwd_body(LA, W)
        dirs, best, bi, bd = K.banded_fwd(a, a_len, b, b_len, bm, **kw)

        def fwd(body):
            return lambda: K._banded_fwd_body(body, a, a_len, b, b_len, bm, **kw)

        both = W <= K.DIAG_W_LIMIT
        turns = [cuda_ms(fwd(x), reps) for x in (("rows", "diag", "diag", "rows") if both else ("rows",) * 2)]
        rows_ms = (turns[0] + turns[-1]) / 2
        diag_ms = (turns[1] + turns[2]) / 2 if both else None
        fwd_ms = diag_ms if body == "diag" else rows_ms
        tb_ms = cuda_ms(lambda: K.banded_tb(dirs, bi, bd, bm, LA=LA, W=W), reps)
        waves_ms = {
            w: cuda_ms(
                lambda: K.banded_fwd_waves(a, a_len, b, b_len, bm, waves=w, **kw), reps
            )
            for w in (WAVES if K.fwd_kernel(LA, W, 2) == "banded_fwd_waves" else ())
        }

        cells, nominal, fwd_bytes = fwd_work(a_len, b_len, bm, LA, LB, W)
        fwd_bound, fwd_by, fwd_ops_ms, fwd_bytes_ms = bound_ms(
            cells * K.FWD_INT_OPS_PER_CELL, fwd_bytes, sm_clock_mhz
        )
        walked = int(bi.sum())
        tb_bound, tb_by, tb_ops_ms, tb_bytes_ms = bound_ms(
            walked * TB_OPS_PER_ROW, 4 * B * LA + 4 * walked + 16 * B, sm_clock_mhz
        )
        label = f"LA={LA} W={W} B={B} {kind}"
        check_shares(label, fwd_bound, {"rows": rows_ms, "diag": diag_ms, **{
            f"waves {w}": ms for w, ms in waves_ms.items()}})
        check_shares(label, tb_bound, {"tb": tb_ms})
        gcells = B * LA * W / ((fwd_ms + tb_ms) * 1e-3) / 1e9
        results[(LA, W, kind)] = {
            "LA": LA, "LB": LB, "W": W, "B": B, "batch": kind, "matched": n_matched,
            "body": body, "rows_plan": plan,
            "nominal_cells": nominal, "in_matrix_cells": cells,
            "fwd_ms": fwd_ms, "rows_ms": rows_ms, "diag_ms": diag_ms,
            "fwd_turns_ms": turns, "tb_ms": tb_ms,
            "fwd_plain_ms": (t1 - t0) * 1e3, "tb_plain_ms": (t2 - t1) * 1e3,
            "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
            "fwd_ops_ms": fwd_ops_ms, "fwd_bytes_ms": fwd_bytes_ms,
            "tb_bound_ms": tb_bound, "tb_bound_by": tb_by,
            "tb_ops_ms": tb_ops_ms, "tb_bytes_ms": tb_bytes_ms,
            "gcells_per_s": gcells, "max_abs_err": max_err,
            "waves_ms": waves_ms, "waves_max_abs_err": max_err,
        }
        log(
            f"kernel {label}"
            + (f" LB={LB}" if LB != LA else "")
            + f": equal, match_compact too (matches {n_matched}); cells nominal {nominal}, in-matrix "
            f"{cells} ({cells / max(1, nominal):.1%}); fwd ({body}) {fwd_ms:.3f} ms; "
            f"anti-diagonal body "
            + (f"{diag_ms:.3f} ms ({fwd_bound / diag_ms:.1%} of bound)" if both else "-")
            + f", row-scan body ({plan['tier']}, {plan['cols_per_thread']} columns a "
            f"thread, {plan['threads']} threads, {plan['blocks']} blocks a pair) "
            f"{rows_ms:.3f} ms ({fwd_bound / rows_ms:.1%}) "
            f"(turns {', '.join(f'{x:.3f}' for x in turns)}; plain "
            f"{(t1 - t0) * 1e3:.1f} ms; bound {fwd_bound:.4f} ms by {fwd_by}); "
            f"tb {tb_ms:.3f} ms (plain {(t2 - t1) * 1e3:.1f} ms, bound "
            f"{tb_bound:.4f} ms by {tb_by}, {tb_bound / tb_ms:.1%}); "
            f"{gcells:.2f} Gcells/s (B*LA*W / fwd+tb)"
        )
        for w, ms in waves_ms.items():
            log(
                f"  banded_fwd_waves LA={LA} W={W} B={B} waves={w}: equal; {ms:.3f} ms "
                f"(bound {fwd_bound:.4f} ms by {fwd_by}, {fwd_bound / ms:.1%}; plain "
                f"{(t1 - t0) * 1e3:.1f} ms; banded_fwd ({body}) {fwd_ms:.3f} ms, "
                f"ratio {ms / fwd_ms:.2f})"
            )
        del dirs, pfused
    return results


# int32 operations kmer_table's bound counts an id: the reverse complement
# 8, the 64-bit key's add 2, two MurmurHash2 blocks 6 each, the finalizer 5.
KMER_TABLE_OPS_PER_ID = 27


def phase_kmer_table(sm_clock_mhz):
    """kmer_table against numpy: the k-14 table built through
    data/kmers.py's card path, bit for bit equal to the spot-check
    worker's numpy table (sha256 of every byte) and, on a stride of ids,
    to kmer_downsampling_hash here; then the kernel's time at k 14 in one
    launch against its bound."""
    from shasta_tpu_torch.data import kmers as KM
    from shasta_tpu_torch.ops import align_kernel as K

    k = ont_k()
    n = 1 << (2 * k)
    digest = _SPOT["pool"].apply_async(_ds_table_digest, (k,))
    KM._TABLES.clear()
    before = K.KMER_TABLE_LAUNCHES
    table = KM.downsampling_hash_table(k, "cuda")
    build = dict(KM.LAST_BUILD)
    if K.KMER_TABLE_LAUNCHES != before + 1 or build["path"] != "device":
        raise AssertionError(f"kmer_table: the card path took {K.KMER_TABLE_LAUNCHES - before} "
                             f"launches, {build}")
    ids = np.arange(0, n, 4099, dtype=np.uint64)
    if not np.array_equal(table[ids.astype(np.int64)], KM.kmer_downsampling_hash(ids, k)):
        raise AssertionError(f"kmer_table != kmer_downsampling_hash on a stride of ids at k {k}")
    got = hashlib.sha256(memoryview(table)).hexdigest()
    KM._TABLES.clear()
    del table
    want, plain_s = digest.get()
    if got != want:
        raise AssertionError(f"kmer_table's table at k {k} != the numpy table: sha256 {got} != {want}")
    buf = torch.empty(n, dtype=torch.int32, device="cuda")
    turns = [cuda_ms(lambda: K.kmer_table(buf, k), 20) for _ in range(3)]
    del buf
    torch.cuda.empty_cache()
    ms = min(turns)
    bound, by, _, _ = bound_ms(n * KMER_TABLE_OPS_PER_ID, 4 * n, sm_clock_mhz)
    check_shares(f"kmer_table k={k}", bound, {"kmer_table": ms})
    log(f"kmer_table k={k} ({n} ids): equal to the numpy table bit for bit (sha256 {got}); "
        f"{ms:.4f} ms (turns {', '.join(f'{x:.4f}' for x in turns)}; bound {bound:.4f} ms by "
        f"{by}, {bound / ms:.1%}); the card path's build with its copy to the host "
        f"{build['seconds']:.3f} s, numpy's {plain_s:.1f} s (the spot-check worker)")
    return {"k": k, "ids": n, "ms": ms, "turns_ms": turns, "bound_ms": bound, "bound_by": by,
            "plain_ms": plain_s * 1e3, "build_s": build["seconds"], "sha256": got}


def phase_blocks_per_sm():
    """Whether a one-warp block is bound by its own latency or by what
    the SM can issue: at 4096 x 128, both banded_fwd bodies and
    banded_fwd_waves (waves 2 and 4) with 1, 2, 4, 8 and 16 pairs per SM
    (for banded_fwd up to 4 warps on each SM sub-partition, for the waves
    kernel a half and a quarter of that). Times that stay flat as the
    pairs grow mean latency-bound warps."""
    from shasta_tpu_torch.ops import align_kernel as K

    LA, W = 4096, 128
    kw = dict(LA=LA, LB=LA, W=W, **SCORES)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for per_sm in (1, 2, 4, 8, 16):
        B = sms * per_sm
        host = make_batch(LA + B, B, LA, W)
        dev = [torch.from_numpy(x).cuda() for x in host]
        a, a_len, b, b_len, bm = K.prepare_inputs(*dev, LA=LA, LB=LA, W=W)
        row = {"B": B}
        for body in ("diag", "rows"):
            row[f"{body}_ms"] = cuda_ms(
                lambda: K._banded_fwd_body(body, a, a_len, b, b_len, bm, **kw), 5
            )
        for w in WAVES:
            row[f"waves{w}_ms"] = cuda_ms(
                lambda: K.banded_fwd_waves(a, a_len, b, b_len, bm, waves=w, **kw), 5
            )
        out[per_sm] = row
        log(
            f"pairs per SM {per_sm} LA={LA} W={W} B={B}: banded_fwd anti-diagonal "
            f"{row['diag_ms']:.3f} ms, row-scan {row['rows_ms']:.3f} ms, waves 2 "
            f"{row['waves2_ms']:.3f} ms, waves 4 {row['waves4_ms']:.3f} ms"
        )
    return out


# ---------------------------------------------------------------------------
# Phases 3 and 4
# ---------------------------------------------------------------------------


# small_config (tests/test_assembly_e2e.py) as --Section.key overrides
# of the configuration defaults (an empty conf file).
SMALL_OVERRIDES = [
    "--Reads.minReadLength", "500", "--Kmers.k", "8",
    "--Kmers.probability", "0.1", "--MinHash.hashFraction", "0.05",
    "--MinHash.minHashIterationCount", "6", "--MinHash.maxBucketSize", "60",
    "--Align.minAlignedMarkerCount", "20", "--Align.maxSkip", "60",
    "--Align.maxDrift", "60", "--Align.maxTrim", "60",
    "--ReadGraph.maxAlignmentCount", "8", "--MarkerGraph.minCoverage", "3",
]


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


def reset_launches():
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.utils import peak

    for counts in (K.LAUNCHES, peak.LAUNCHES):
        for k in counts:
            counts[k] = 0
    K.KMER_TABLE_LAUNCHES = 0


@contextlib.contextmanager
def waves_env(value):
    """SHASTA_TORCH_WAVES set for the duration (None: unset)."""
    old = os.environ.pop("SHASTA_TORCH_WAVES", None)
    if value is not None:
        os.environ["SHASTA_TORCH_WAVES"] = value
    try:
        yield
    finally:
        os.environ.pop("SHASTA_TORCH_WAVES", None)
        if old is not None:
            os.environ["SHASTA_TORCH_WAVES"] = old


def golden_inputs(work):
    """The golden input's reads (25 kb genome, seed 4242, 130 reads of 3
    kb, seed 4243) and an empty conf file (the configuration defaults),
    written once into ``work``."""
    from shasta_tpu_torch.utils import synth

    fasta = os.path.join(work, "golden.fasta")
    conf = os.path.join(work, "defaults.conf")
    if not os.path.exists(fasta):
        genome = synth.random_genome(25000, seed=4242)
        reads = synth.sample_reads(genome, 130, 3000, seed=4243, both_strands=True)
        synth.write_fasta(fasta, reads)
        open(conf, "w").close()
    return fasta, conf


def phase_golden(work):
    from shasta_tpu_torch.__main__ import main as cli
    from shasta_tpu_torch.ops import align_kernel as K

    fasta, conf = golden_inputs(work)
    with open(GOLDEN) as f:
        pinned = json.load(f)
    with open(GOLDEN_METRICS) as f:
        metrics = json.load(f)
    outputs = {}
    for label, device, waves in (
        ("cuda", "cuda", None), ("cuda-waves2", "cuda", "2"),
        ("cuda-waves4", "cuda", "4"), ("cpu", "cpu", None),
    ):
        run_dir = os.path.join(work, f"golden-{label}")
        reset_launches()
        t0 = time.perf_counter()
        with waves_env(waves), contextlib.redirect_stdout(io.StringIO()):
            rc = cli([
                "--command", "assemble", "--config", conf, "--input", fasta,
                "--assemblyDirectory", run_dir, "--device", device,
                *SMALL_OVERRIDES,
            ])
        launches = dict(K.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"golden assemble ({label}) returned {rc}")
        hashes = stage_hashes(run_dir)
        bad = [s for s in STAGES if hashes.get(s) != pinned[s]]
        if bad:
            raise AssertionError(f"golden ({label}): stage hashes differ: {bad}")
        with open(os.path.join(run_dir, "AssemblySummary.json")) as f:
            summary = json.load(f)
        got = {k: summary[k] for k in GOLDEN_KEYS}
        if got != metrics:
            raise AssertionError(f"golden ({label}): metrics {got} != {metrics}")
        want_waves = label.startswith("cuda-waves")
        if (launches["banded_fwd_waves"] > 0) != want_waves:
            raise AssertionError(f"golden ({label}): launches {launches}")
        if device == "cuda" and launches["banded_tb"] == 0:
            raise AssertionError(f"golden ({label}): no kernel launched: {launches}")
        outputs[label] = {}
        for name in OUTPUTS:
            with open(os.path.join(run_dir, name), "rb") as f:
                outputs[label][name] = f.read()
        log(
            f"golden assemble --device {device}"
            f"{' SHASTA_TORCH_WAVES=' + waves if waves else ''}: "
            f"{time.perf_counter() - t0:.2f}s, launches {launches}"
        )
    if any(out != outputs["cpu"] for out in outputs.values()):
        raise AssertionError("golden: FASTA/GFA files differ across the four runs")
    log(
        "golden: all eight stage hashes equal the pinned values and the summary "
        "equals mode0_metrics.json in the four runs; Assembly.fasta, "
        "Assembly.gfa and Assembly-BothStrands.gfa byte-equal across them"
    )


# The palindrome pass's deltaThreshold past 8192: a self-alignment band
# of 2 x 8200 = 16400 lanes, which the align engine runs in its W class
# 32768, on the row-scan body.
PALINDROME_DELTA = 8200


def small_config():
    """SMALL_OVERRIDES on the configuration defaults."""
    from shasta_tpu_torch.pipeline.config import AssemblyConfig

    cfg = AssemblyConfig()
    for flag, value in zip(SMALL_OVERRIDES[::2], SMALL_OVERRIDES[1::2]):
        cfg.set(*flag[2:].split(".", 1), value)
    return cfg


def palindrome_reads(n=32):
    """tests/torch_common.py:palindrome_reads at n = 32: the golden
    input's first 32 reads and one palindromic read, 1.5 kb of the
    golden genome followed by its reverse complement."""
    from shasta_tpu_torch.data import bases as B
    from shasta_tpu_torch.utils import synth

    genome = synth.random_genome(25000, seed=4242)
    reads = synth.sample_reads(genome, 130, 3000, seed=4243, both_strands=True)[:n]
    half = genome[1000:2500]
    return reads + [np.concatenate([half, B.reverse_complement(half)])]


def phase_palindrome_wide(work, sm_clock_mhz):
    """Phase 3 (b): the palindrome pass at deltaThreshold 8200 on the
    first 32 golden reads and a palindromic read, on the card and on the
    CPU (the plain version takes about half a second per read at this
    width there): equal flags, the palindromic read flagged, and the
    card's launches, from the launch trace, all in the W 32768 class,
    banded_fwd on the row-scan body."""
    from shasta_tpu_torch.ops import align as AL
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.ops.palindrome import flag_palindromic_reads
    from shasta_tpu_torch.pipeline.assemble import Assembler
    from shasta_tpu_torch.utils import synth

    fasta = os.path.join(work, "palindrome.fasta")
    synth.write_fasta(fasta, palindrome_reads())
    asm = Assembler(os.path.join(work, "palindrome"), small_config(), device="cpu")
    asm.add_reads([fasta])
    asm.select_kmers()
    asm.find_markers()
    W = int(AL._bucket(2 * PALINDROME_DELTA, AL._W_BUCKETS))
    flags, out = {}, {}
    for device in ("cuda", "cpu"):
        reset_launches()
        K.TRACE = [] if device == "cuda" else None
        t0 = time.perf_counter()
        flags[device] = flag_palindromic_reads(
            asm.markers, delta_threshold=PALINDROME_DELTA, device=device
        )
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        trace, K.TRACE = K.TRACE, None
        out[device] = {"seconds": secs, "launches": launches}
        log(
            f"palindrome pass deltaThreshold {PALINDROME_DELTA} (band {2 * PALINDROME_DELTA}, "
            f"W class {W}) --device {device}: {secs:.2f}s, {int(flags[device].sum())} of "
            f"{flags[device].shape[0]} reads flagged, launches {launches}"
        )
        if device == "cpu":
            check_card_launches("palindrome cpu", "cpu", None, launches)
            continue
        shapes = kernel_classes(trace, sm_clock_mhz, "palindrome")
        out[device]["shapes"] = shapes
        wrong = [
            c for c in shapes
            if c["W"] != W or (c["kernel"] == "banded_fwd" and c["body"] != "rows")
        ]
        if launches["banded_fwd"] == 0 or launches["banded_tb"] == 0 or wrong:
            raise AssertionError(
                f"palindrome pass: no launch, or a launch outside the W {W} class on the "
                f"row-scan body: {launches}, {wrong}"
            )
    if not np.array_equal(flags["cuda"], flags["cpu"]) or not flags["cpu"][-1]:
        raise AssertionError(
            f"palindrome pass: card flags {flags['cuda'].tolist()} != CPU flags "
            f"{flags['cpu'].tolist()}, or the palindromic read is not flagged"
        )
    log("palindrome pass at a band past 16384 lanes: flags equal on the card and the CPU")
    return out


def grade(label, path, truth):
    """utils/accuracy.assembly_metrics of a FASTA file against the truth
    (one genome or a list of haplotypes): k-mer QV, completeness and
    misassemblies."""
    from shasta_tpu_torch.utils import accuracy as AC

    t0 = time.perf_counter()
    m = AC.assembly_metrics(AC.parse_fasta_contigs(path), truth, k=21)
    log(
        f"{label} grade of {os.path.basename(path)}: qv {m['qv']}, completeness "
        f"{m['completeness']}, misassemblies {m['misassemblies']} ({m}); "
        f"{time.perf_counter() - t0:.1f}s"
    )
    return m


def kernel_classes(trace, sm_clock_mhz, label, echo=True):
    """Per (kernel, LA, W) launches, pairs, device ms, work and bound of
    one traced run; prints one line per class with ``echo``. The work:
    banded_fwd's in-matrix cells (fwd_work: the bound counts their
    operations, and the bytes of the inputs and of every dirs word of a
    processed row), banded_tb's walked rows (one dirs word read per row,
    the (B, LA) matches written)."""
    from shasta_tpu_torch.ops import align_kernel as K

    by_shape = {}
    for name, body, LA, W, B, work, start, end in trace:
        e = by_shape.setdefault((name, body, LA, W), [0, 0, 0.0, 0, 0, 0, 0, 0, 0])
        if name.startswith("banded_fwd"):
            a_len, b_len, band_min, LB = work
            cells, processed, nbytes = fwd_work(a_len, b_len, band_min, LA, LB, W)
            ops = cells * K.FWD_INT_OPS_PER_CELL
        else:
            cells = processed = int(work[0].sum())
            nbytes = 4 * B * LA + 4 * cells + 16 * B
            ops = cells * TB_OPS_PER_ROW
        for k, x in enumerate((1, B, start.elapsed_time(end), cells, B * LA * W, 0,
                               processed, ops, nbytes)):
            e[k] += x
        e[5] = max(e[5], B)
    shapes = []
    for (name, body, LA, W), e in sorted(by_shape.items()):
        n, B, ms, work, nominal, bmax, processed, ops, nbytes = e
        bound, by, _ops_ms, _bytes_ms = bound_ms(ops, nbytes, sm_clock_mhz)
        shapes.append({
            "kernel": name, "body": body, "LA": LA, "W": W, "launches": n, "pairs": B,
            "max_pairs_per_launch": bmax, "device_ms": ms, "work": work,
            "processed_cells": processed, "nominal_cells": nominal,
            "bound_ms": bound, "bound_by": by,
        })
        if echo:
            log(
                f"  [{label}] {name} ({body}) LA={LA} W={W}: {n} launches, {B} pairs "
                f"({B / n:.0f} per launch, at most {bmax}), {ms:.2f} ms "
                f"(bound {bound:.4f} ms by {by}, {bound / ms:.1%})"
                + (f"; cells processed {processed}, in-matrix {work}"
                   if name.startswith("banded_fwd") else "")
            )
    return shapes


def compare_classes(default, waves):
    """The forward kernels' per-(LA, W) device ms of the main run's
    computeAlignments beside the waves-2 rerun's (the same pairs, launched
    alike), with the default's pairs per launch; prints one line per class
    and returns the rows."""
    rows = {}
    for label, shapes in (("default", default), ("waves2", waves)):
        for c in shapes:
            if c["kernel"] == "banded_tb":
                continue
            r = rows.setdefault((c["LA"], c["W"]), {"LA": c["LA"], "W": c["W"]})
            r[f"{label}_kernel"] = f"{c['kernel']} ({c['body']})"
            r[f"{label}_ms"] = c["device_ms"]
            r[f"{label}_launches"] = c["launches"]
            r[f"{label}_pairs"] = c["pairs"]
            r[f"{label}_max_pairs_per_launch"] = c["max_pairs_per_launch"]
    for (LA, W), r in sorted(rows.items()):
        if "default_ms" not in r or "waves2_ms" not in r:
            raise AssertionError(f"a forward class ran in one rerun only: {r}")
        log(
            f"  forward LA={LA} W={W}: default {r['default_kernel']} "
            f"{r['default_ms']:.2f} ms, waves 2 {r['waves2_kernel']} {r['waves2_ms']:.2f} ms "
            f"(ratio {r['waves2_ms'] / r['default_ms']:.2f}); {r['default_launches']} "
            f"launches, {r['default_pairs'] / r['default_launches']:.0f} pairs per launch "
            f"(at most {r['default_max_pairs_per_launch']})"
        )
    return list(rows.values())


def phase_real_size(work, sm_clock_mhz):
    from shasta_tpu_torch.data import kmers as KM
    from shasta_tpu_torch.data.kmers import KmerTable
    from shasta_tpu_torch.data.markers import MarkerStore
    from shasta_tpu_torch.data.reads import ReadStore
    from shasta_tpu_torch.data.store import RunStore
    from shasta_tpu_torch.ops import align as AL
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.ops.lowhash import CandidatePairs
    from shasta_tpu_torch.pipeline.assemble import Assembler, run_assembly
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
    run_dir = os.path.join(work, "ont5mb")

    # The main path: counts to 0 just before, read just after. The trace's
    # span of computeAlignments is kept for the waves-2 comparison.
    span = []
    compute_alignments = Assembler.compute_alignments

    def traced_compute_alignments(self):
        span.append(len(K.TRACE))
        compute_alignments(self)
        span.append(len(K.TRACE))

    KM._TABLES.clear()  # the run builds its own downsampling table
    reset_launches()
    K.TRACE = []
    torch.cuda.reset_peak_memory_stats()
    Assembler.compute_alignments = traced_compute_alignments
    t0 = time.perf_counter()
    try:
        with waves_env(None), contextlib.redirect_stdout(io.StringIO()):
            summary = run_assembly([fasta], run_dir, cfg, device="cuda")
    finally:
        Assembler.compute_alignments = compute_alignments
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    kmer_table_launches = K.KMER_TABLE_LAUNCHES
    trace, K.TRACE = K.TRACE, None
    peak = torch.cuda.max_memory_allocated()
    times = summary["stageSeconds"]

    missing = [f for f in MODE0_FILE_FAMILY if not os.path.exists(os.path.join(run_dir, f))]
    if missing:
        raise AssertionError(f"real size: files missing from the run directory: {missing}")
    if summary["assembledSegmentCount"] < 1:
        raise AssertionError("real size: no segment assembled")
    log(f"real size run_assembly: {wall:.2f}s wall; stage seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    log(
        f"real size: reads {summary['readCount']}, candidates "
        f"{summary['alignmentCandidateCount']}, alignments {summary['alignmentCount']}, "
        f"palindromic {summary['palindromicReadCount']}, chimeric "
        f"{summary['chimericReadCount']}; markerGraphMinCoverageUsed "
        f"{summary['markerGraphMinCoverageUsed']}, marker graph vertices "
        f"{summary['markerGraphVertexCount']}, edges {summary['markerGraphEdgeCount']}; "
        f"segments {summary['assembledSegmentCount']}, total length "
        f"{summary['totalAssembledSegmentLength']}, longest "
        f"{summary['longestAssembledSegmentLength']}, N50 {summary['assembledSegmentN50']}"
    )
    shapes = kernel_classes(trace, sm_clock_mhz, "main path")
    fwd_ms = sum(c["device_ms"] for c in shapes if c["kernel"] == "banded_fwd")
    tb_ms = sum(c["device_ms"] for c in shapes if c["kernel"] == "banded_tb")
    nominal = sum(c["nominal_cells"] for c in shapes if c["kernel"] == "banded_fwd")
    real_cells = sum(c["processed_cells"] for c in shapes if c["kernel"] == "banded_fwd")
    in_matrix = sum(c["work"] for c in shapes if c["kernel"] == "banded_fwd")
    dp_wall = times["flagPalindromicReads"] + times["computeAlignments"]
    log(
        f"real size launches: {launches}; peak device memory {peak / 2**30:.2f} GiB; "
        f"peak RSS {summary['peakMemoryUsageKB'] / 2**20:.2f} GiB (this process); "
        f"kernel device time fwd {fwd_ms:.1f} ms, tb {tb_ms:.1f} ms; card-side "
        f"{nominal / ((fwd_ms + tb_ms) * 1e-3) / 1e9:.2f} Gcells/s (B*LA*W), "
        f"{real_cells / (fwd_ms * 1e-3) / 1e9:.2f} Gcells/s of processed rows in banded_fwd "
        f"({in_matrix} in-matrix cells of {real_cells}, "
        f"{in_matrix / (fwd_ms * 1e-3) / 1e9:.2f} Gcells/s); "
        f"the two kernels are busy {(fwd_ms + tb_ms) / 1e3 / dp_wall:.1%} of the "
        f"wall time of the two stages that launch them ({dp_wall:.2f}s)"
    )
    if launches["banded_fwd"] == 0 or launches["banded_tb"] == 0:
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    if kmer_table_launches != 1 or KM.LAST_BUILD.get("path") != "device":
        raise AssertionError(f"the main path built its downsampling table in "
                             f"{kmer_table_launches} kmer_table launches, {KM.LAST_BUILD}")
    log(f"real size: the downsampling table of k {KM.LAST_BUILD['k']} built on the card "
        f"in {KM.LAST_BUILD['seconds']:.3f} s, one kmer_table launch")
    if launches["banded_fwd_waves"] != 0:
        raise AssertionError(f"the waves kernel ran at SHASTA_TORCH_WAVES unset: {launches}")
    if not any(c["LA"] >= 8192 for c in shapes):
        raise AssertionError("no launch at LA >= 8192 on the main path")
    fwd_classes = [c for c in shapes if c["kernel"] == "banded_fwd"]
    diag_ws = {c["W"] for c in fwd_classes if c["body"] == "diag"}
    wrong = [c for c in fwd_classes if c["body"] != K.fwd_body(c["LA"], c["W"])]
    if not {128, 512} <= diag_ws or wrong:
        raise AssertionError(
            f"a banded_fwd class ran another body than fwd_body picks, or no W 128 "
            f"or 512 class ran the anti-diagonal body: {diag_ws}, {wrong}"
        )

    # The run's own stage data, reloaded from its store.
    store = RunStore(run_dir, create=False)
    markers = MarkerStore.from_arrays(store.load_stage("Markers"))
    kmer_table = KmerTable.from_arrays(store.load_stage("Kmers"))
    aligned = AL.AlignmentStore.from_arrays(store.load_stage("Alignments"))
    if not aligned.check_strictly_increasing():
        raise AssertionError("alignment ordinals not strictly increasing")

    graded = grade("real size", os.path.join(run_dir, "Assembly.fasta"), genome)
    del genome
    shas = {"fasta_sha256": file_sha256(fasta),
            "assembly_fasta_sha256": file_sha256(os.path.join(run_dir, "Assembly.fasta"))}
    log(f"real size: sha256 of the reads {shas['fasta_sha256']}, of Assembly.fasta "
        f"{shas['assembly_fasta_sha256']}")

    # computeAlignments again on the run's Markers and AlignmentCandidates
    # with the waves kernel: counts to 0 just before, read just after. Its
    # classes are those of the main run's computeAlignments.
    reruns = {"default": {
        "compute_alignments_s": times["computeAlignments"],
        "shapes": kernel_classes(trace[span[0]:span[1]], sm_clock_mhz, "default", echo=False),
    }}
    rerun_dir = os.path.join(work, "ont5mb-waves2")
    asm = Assembler(rerun_dir, cfg, device="cuda")
    asm.reads = ReadStore.from_arrays(store.load_stage("Reads"))
    asm.kmer_table = kmer_table
    asm.markers = markers
    asm.candidates = CandidatePairs.from_arrays(store.load_stage("AlignmentCandidates"))
    reset_launches()
    K.TRACE = []
    t0 = time.perf_counter()
    with waves_env("2"):
        asm.compute_alignments()
    secs = time.perf_counter() - t0
    rerun_launches = dict(K.LAUNCHES)
    rerun_trace, K.TRACE = K.TRACE, None
    log(
        f"real size computeAlignments again (SHASTA_TORCH_WAVES=2): {secs:.2f}s (main "
        f"run {times['computeAlignments']:.2f}s), launches {rerun_launches}"
    )
    reruns["waves2"] = {
        "compute_alignments_s": secs, "launches": rerun_launches,
        "shapes": kernel_classes(rerun_trace, sm_clock_mhz, "waves2"), "dir": rerun_dir,
    }
    run_hashes = stage_hashes(run_dir)
    h = stage_hashes(rerun_dir)["Alignments"]
    if h != run_hashes["Alignments"]:
        raise AssertionError(f"Alignments hash differs in the waves-2 rerun: {h[:12]}")
    waves_launches = reruns["waves2"]["launches"]
    waves_shapes = reruns["waves2"]["shapes"]
    if waves_launches["banded_fwd_waves"] == 0:
        raise AssertionError(f"banded_fwd_waves never launched: {waves_launches}")
    wrong = [
        c for c in waves_shapes
        if c["kernel"] != "banded_tb" and c["kernel"] != K.fwd_kernel(c["LA"], c["W"], 2)
    ]
    if wrong:
        raise AssertionError(
            f"a forward class under waves 2 ran another kernel than fwd_kernel picks: {wrong}"
        )
    by_class = compare_classes(reruns["default"]["shapes"], waves_shapes)
    totals = {}
    for label, r in reruns.items():
        fwd = sum(c["device_ms"] for c in r["shapes"] if c["kernel"] != "banded_tb")
        tb = sum(c["device_ms"] for c in r["shapes"] if c["kernel"] == "banded_tb")
        totals[label] = {"fwd_ms": fwd, "tb_ms": tb}
        r.update(totals[label])
    d, w = totals["default"], totals["waves2"]
    log(
        f"real size computeAlignments kernel device time: main run fwd {d['fwd_ms']:.1f} + "
        f"tb {d['tb_ms']:.1f} = {d['fwd_ms'] + d['tb_ms']:.1f} ms; waves 2 fwd "
        f"{w['fwd_ms']:.1f} + tb {w['tb_ms']:.1f} = {w['fwd_ms'] + w['tb_ms']:.1f} ms "
        f"(ratio {(w['fwd_ms'] + w['tb_ms']) / (d['fwd_ms'] + d['tb_ms']):.2f}); "
        f"Alignments hash equal to the main run's"
    )
    spot_check_later("real size", run_dir, cfg)
    return {
        "dir": run_dir, "launches": launches, "times": times, "wall_s": wall,
        "kmer_table_launches": kmer_table_launches, "table_build": dict(KM.LAST_BUILD),
        "peak_bytes": peak,
        "peak_rss_kb": summary["peakMemoryUsageKB"],
        "summary": {k: v for k, v in summary.items() if not isinstance(v, (dict, list))},
        "shapes": shapes, "fwd_ms": fwd_ms, "tb_ms": tb_ms, "nominal_cells": nominal,
        "processed_cells": real_cells, "in_matrix_cells": in_matrix,
        "reruns": reruns, "by_class": by_class, "grade": graded, "hashes": run_hashes,
        **shas,
    }

# ---------------------------------------------------------------------------
# Phases 5 to 7
# ---------------------------------------------------------------------------


# tests/test_reference_parity.py:_golden_run_mode2's configuration as
# overrides: small_config, mode 2, minEdgeCoverage 3, per strand 0,
# bubble-removal component-size threshold 3.
MODE2_OVERRIDES = SMALL_OVERRIDES + [
    "--Assembly.mode", "2", "--MarkerGraph.minEdgeCoverage", "3",
    "--MarkerGraph.minEdgeCoveragePerStrand", "0",
    "--Assembly.mode2.bubbleRemoval.componentSizeThreshold", "3",
]


def write_mode2_golden_reads(path):
    """_golden_run_mode2's reads (tests/torch_common.py:write_mode2_reads):
    two 15 kb haplotypes with a SNP every 700 bases, 90 + 90 reads of
    2.5 kb from both strands, seeds 4343 to 4446."""
    from shasta_tpu_torch.utils import synth

    rng = np.random.default_rng(4343)
    hap_a = synth.random_genome(15000, seed=4444)
    hap_b = hap_a.copy()
    for p in np.arange(350, 15000, 700):
        hap_b[p] = (hap_b[p] + 1 + rng.integers(0, 3)) % 4
    reads = synth.sample_reads(hap_a, 90, 2500, seed=4445, both_strands=True)
    reads += synth.sample_reads(hap_b, 90, 2500, seed=4446, both_strands=True)
    synth.write_fasta(path, reads)


def file_sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def file_hashes(run_dir, names):
    return {f"file:{name}": file_sha256(os.path.join(run_dir, name)) for name in names}


def run_cli(label, work, argv, waves=None):
    """The assemble command with the launch counts reset just before and
    read just after; returns (run dir, summary, launches, seconds)."""
    from shasta_tpu_torch.__main__ import main as cli
    from shasta_tpu_torch.ops import align_kernel as K

    run_dir = os.path.join(work, label)
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with waves_env(waves), contextlib.redirect_stdout(out):
        rc = cli(["--command", "assemble", "--assemblyDirectory", run_dir, *argv])
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"{label}: assemble returned {rc}")
    return run_dir, json.loads(out.getvalue()), launches, secs


def check_card_launches(label, device, waves, launches):
    """A card run launched banded_tb, and banded_fwd_waves exactly when
    SHASTA_TORCH_WAVES asked for it; a CPU run launched nothing."""
    if device == "cpu":
        if any(launches.values()):
            raise AssertionError(f"{label}: a kernel launched on the CPU run: {launches}")
        return
    if launches["banded_tb"] == 0 or (launches["banded_fwd_waves"] > 0) != bool(waves):
        raise AssertionError(f"{label}: launches {launches}")


def phase_mode2_golden(work):
    """Phase 5: the mode-2 golden input through the assemble command on
    the card, on the card under SHASTA_TORCH_WAVES=2, and on the CPU;
    all 17 values of tests/golden/mode2_stage_hashes.json in each."""
    fasta = os.path.join(work, "golden-mode2.fasta")
    write_mode2_golden_reads(fasta)
    _, conf = golden_inputs(work)
    with open(GOLDEN_MODE2) as f:
        pinned = json.load(f)
    files = [k[len("file:"):] for k in pinned if k.startswith("file:")]
    out = {}
    for label, device, waves in (
        ("mode2-golden-cuda", "cuda", None), ("mode2-golden-cuda-waves2", "cuda", "2"),
        ("mode2-golden-cpu", "cpu", None),
    ):
        run_dir, summary, launches, secs = run_cli(
            label, work,
            ["--config", conf, "--input", fasta, "--device", device, *MODE2_OVERRIDES],
            waves=waves,
        )
        got = stage_hashes(run_dir)
        got.update(file_hashes(run_dir, files))
        bad = sorted(k for k in pinned if got.get(k) != pinned[k])
        if bad or len(pinned) != 17:
            raise AssertionError(f"{label}: values differ from the pinned ones: {bad}")
        check_card_launches(label, device, waves, launches)
        out[label] = {"seconds": secs, "launches": launches,
                      "phased_bubbles": summary["phasedBubbleCount"]}
        log(
            f"mode-2 golden assemble --device {device}"
            f"{' SHASTA_TORCH_WAVES=' + waves if waves else ''}: {secs:.2f}s, "
            f"{summary['phasedBubbleCount']} of {summary['diploidBubbleCount']} bubbles "
            f"phased, launches {launches}"
        )
    log(
        "mode-2 golden: all 17 values of mode2_stage_hashes.json (8 stage manifests, "
        "9 output files) equal the pinned ones in the three runs"
    )
    return out


def fasta_stats(path):
    """(sequences, total length, N50) of a FASTA file."""
    lengths, n = [], 0
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if n or lengths:
                    lengths.append(n)
                n = 0
            else:
                n += len(line.strip())
    if n or lengths:
        lengths.append(n)
    lengths.sort(reverse=True)
    total, acc, n50 = sum(lengths), 0, 0
    for x in lengths:
        acc += x
        if 2 * acc >= total:
            n50 = x
            break
    return len(lengths), total, n50


def diploid_reads(genome_len, coverage, seeds=(600, 601, 602, 603)):
    """Haplotype A a random genome; haplotype B A with one substitution
    every 1,000 bases at a seeded jitter of up to 250; ONT-like reads
    (phase 4's length model) at ``coverage`` on each haplotype. Returns
    (reads, SNP count, (haplotype A, haplotype B))."""
    from shasta_tpu_torch.utils import synth

    hap_a = synth.random_genome(genome_len, seed=seeds[0])
    rng = np.random.default_rng(seeds[1])
    pos = np.arange(500, genome_len - 500, 1000)
    pos = pos + rng.integers(-250, 251, pos.shape[0])
    hap_b = hap_a.copy()
    hap_b[pos] = (hap_b[pos] + 1 + rng.integers(0, 3, pos.shape[0])) % 4
    kw = dict(median_length=25000, sigma=0.55, min_length=3000)
    reads = synth.sample_reads_ont(hap_a, coverage, seed=seeds[2], **kw)
    reads += synth.sample_reads_ont(hap_b, coverage, seed=seeds[3], **kw)
    return reads, int(pos.shape[0]), (hap_a, hap_b)


def log_counts(path):
    """(secondary edges added, secondary edges split, edges they split
    into) from a run's performance.log."""
    added = split = new = 0
    with open(path) as f:
        for line in f:
            if m := re.search(r"Added (\d+) \+ (\d+) secondary edges", line):
                added = int(m.group(1)) + int(m.group(2))
            elif m := re.search(r"Split (\d+) secondary edges into (\d+)", line):
                split, new = int(m.group(1)), int(m.group(2))
    return added, split, new


def phase_mode2_real_size(work, sm_clock_mhz, genome_len=2_000_000, coverage=15.0):
    """Phase 6: mode 2 at a real size on the card, Nanopore-Phased-May2022
    verbatim; the launch counts reset just before the run, read just
    after; 128 kept pairs re-aligned with the plain version."""
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.pipeline.assemble import run_assembly
    from shasta_tpu_torch.pipeline.config import AssemblyConfig
    from shasta_tpu_torch.pipeline.configurations import get_configuration
    from shasta_tpu_torch.utils import synth

    t0 = time.perf_counter()
    reads, n_het, haps = diploid_reads(genome_len, coverage)
    fasta = os.path.join(work, "diploid.fasta")
    synth.write_fasta(fasta, reads)
    log(
        f"mode 2 real size: two {genome_len / 1e6:.1f} Mb haplotypes, {n_het} "
        f"heterozygous SNPs; {len(reads)} reads at {coverage:g}x per haplotype, "
        f"{sum(r.shape[0] for r in reads) / 1e6:.1f} Mb, generated in "
        f"{time.perf_counter() - t0:.1f}s"
    )
    del reads
    cfg = AssemblyConfig.from_conf_text(get_configuration("Nanopore-Phased-May2022"))
    run_dir = os.path.join(work, "diploid")

    reset_launches()
    K.TRACE = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with waves_env(None), contextlib.redirect_stdout(io.StringIO()):
        summary = run_assembly([fasta], run_dir, cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    trace, K.TRACE = K.TRACE, None
    peak = torch.cuda.max_memory_allocated()
    times = summary["stageSeconds"]
    log(f"mode 2 real size run_assembly: {wall:.2f}s wall; stage seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    added, split, new = log_counts(os.path.join(run_dir, "performance.log"))
    strict = summary["markerGraphEdgeCount"] - added - new
    fa = {name: fasta_stats(os.path.join(run_dir, f"Assembly-{name}.fasta"))
          for name in ("Phased", "Haploid")}
    log(
        f"mode 2 real size: reads {summary['readCount']}, candidates "
        f"{summary['alignmentCandidateCount']}, alignments {summary['alignmentCount']}; "
        f"markerGraphMinCoverageUsed {summary['markerGraphMinCoverageUsed']}, marker "
        f"graph vertices {summary['markerGraphVertexCount']}, strict edges {strict}, "
        f"secondary edges {added} ({split} split into {new}); bubbles "
        f"{summary['diploidBubbleCount']}, phased bubbles {summary['phasedBubbleCount']}, "
        f"phased components {summary['phasedComponentCount']}, bubble chains "
        f"{summary['bubbleChainCount']}; "
        + "; ".join(
            f"Assembly-{name}.fasta {n} sequences, total {total}, N50 {n50}"
            for name, (n, total, n50) in fa.items()
        )
    )
    shapes = kernel_classes(trace, sm_clock_mhz, "mode 2")
    fwd_ms = sum(c["device_ms"] for c in shapes if c["kernel"] != "banded_tb")
    tb_ms = sum(c["device_ms"] for c in shapes if c["kernel"] == "banded_tb")
    dp_wall = times["flagPalindromicReads"] + times["computeAlignments"]
    log(
        f"mode 2 real size launches: {launches}; peak device memory "
        f"{peak / 2**30:.2f} GiB; kernel device time fwd {fwd_ms:.1f} ms, tb "
        f"{tb_ms:.1f} ms, busy {(fwd_ms + tb_ms) / 1e3 / dp_wall:.1%} of the two DP "
        f"stages' {dp_wall:.2f}s"
    )
    if launches["banded_fwd"] == 0 or launches["banded_tb"] == 0:
        raise AssertionError(f"mode 2 real size: a kernel never launched: {launches}")
    if summary["phasedBubbleCount"] < 1 or fa["Phased"][1] == 0:
        raise AssertionError(
            f"mode 2 real size: {summary['phasedBubbleCount']} phased bubbles, "
            f"Assembly-Phased.fasta {fa['Phased'][1]} bases"
        )
    graded = grade_diploid(run_dir, *haps)
    spot_check_later("mode 2 real size", run_dir, cfg)
    return {
        "launches": launches, "times": times, "wall_s": wall, "peak_bytes": peak,
        "summary": {k: v for k, v in summary.items() if not isinstance(v, (dict, list))},
        "strict_edges": strict, "secondary_edges": added,
        "secondary_split": [split, new],
        "fasta": {k: dict(zip(("sequences", "total", "n50"), v)) for k, v in fa.items()},
        "shapes": shapes, "fwd_ms": fwd_ms, "tb_ms": tb_ms, "coverage": coverage,
        "grade": graded,
    }


def grade_diploid(run_dir, hap_a, hap_b):
    """Assembly-Phased.fasta against the two haplotypes
    (diploid_phasing_metrics and phasing_switch_errors) and
    Assembly-Haploid.fasta with both as the truth (assembly_metrics)."""
    from shasta_tpu_torch.utils import accuracy as AC

    t0 = time.perf_counter()
    phased = AC.parse_fasta_contigs(os.path.join(run_dir, "Assembly-Phased.fasta"))
    out = {
        "phasing": AC.diploid_phasing_metrics(phased, hap_a, hap_b, k=21),
        "switches": AC.phasing_switch_errors(phased, hap_a, hap_b),
    }
    log(
        f"mode 2 real size grade of Assembly-Phased.fasta: phasing {out['phasing']}; "
        f"switch errors {out['switches']}; {time.perf_counter() - t0:.1f}s"
    )
    out["haploid"] = grade(
        "mode 2 real size", os.path.join(run_dir, "Assembly-Haploid.fasta"), [hap_a, hap_b]
    )
    return out


def phase_method4_golden(work):
    """Phase 7 (a): the mode-0 golden input under --Align.alignMethod 4 on
    the card and on the CPU: equal Alignments manifests, byte-equal
    FASTA/GFA."""
    fasta, conf = golden_inputs(work)
    runs = {}
    for label, device in (("method4-golden-cuda", "cuda"), ("method4-golden-cpu", "cpu")):
        run_dir, summary, launches, secs = run_cli(
            label, work,
            ["--config", conf, "--input", fasta, "--device", device, *SMALL_OVERRIDES,
             "--Align.alignMethod", "4"],
        )
        check_card_launches(label, device, None, launches)
        runs[device] = (stage_hashes(run_dir)["Alignments"], file_hashes(run_dir, OUTPUTS))
        log(
            f"method 4 golden assemble --device {device}: {secs:.2f}s, "
            f"{summary['alignmentCount']} alignments, launches {launches}"
        )
    if runs["cuda"] != runs["cpu"]:
        raise AssertionError("method 4 golden: Alignments or FASTA/GFA differ card/CPU")
    log("method 4 golden: Alignments manifest and FASTA/GFA equal on the card and the CPU")


def phase_method4_real_size(ont_dir, sm_clock_mhz, n_pairs=2048):
    """Phase 7 (b): align_candidates_method4 on the card over the first
    ``n_pairs`` candidates of phase 4's run, on its own Markers; the host
    time of align4_bands apart from the kernels'; 128 seeded tasks
    re-aligned with the plain version on the card."""
    from shasta_tpu_torch.data.markers import MarkerStore
    from shasta_tpu_torch.data.store import RunStore
    from shasta_tpu_torch.ops import align as AL
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.ops import align_other as AO
    from shasta_tpu_torch.ops.lowhash import CandidatePairs
    from shasta_tpu_torch.pipeline.config import AssemblyConfig
    from shasta_tpu_torch.pipeline.configurations import get_configuration

    store = RunStore(ont_dir, create=False)
    markers = MarkerStore.from_arrays(store.load_stage("Markers"))
    cand = CandidatePairs.from_arrays(store.load_stage("AlignmentCandidates"))
    cfg = AssemblyConfig.from_conf_text(get_configuration("Nanopore-May2022"))
    ca = cfg.align
    sel = slice(0, min(n_pairs, cand.count))
    bands_s = [0.0]
    grouped = {}
    real_bands, real_grouped = AO.align4_bands, AL._grouped_run

    def timed_bands(*args, **kwargs):
        t = time.perf_counter()
        try:
            return real_bands(*args, **kwargs)
        finally:
            bands_s[0] += time.perf_counter() - t

    def recorded_grouped(*args, **kwargs):
        out = real_grouped(*args, **kwargs)
        grouped["args"], grouped["out"] = args, out
        return out

    AO.align4_bands, AL._grouped_run = timed_bands, recorded_grouped
    reset_launches()
    K.TRACE = []
    t0 = time.perf_counter()
    try:
        st = AO.align_candidates_method4(
            markers, cand.read_id0[sel], cand.read_id1[sel], cand.same_strand[sel],
            _align_params(cfg), delta_x=ca.align4_delta_x, delta_y=ca.align4_delta_y,
            min_entry_count=ca.align4_min_entry_count_per_cell,
            max_distance_from_boundary=ca.align4_max_distance_from_boundary,
            device="cuda",
        )
        torch.cuda.synchronize()
    finally:
        AO.align4_bands, AL._grouped_run = real_bands, real_grouped
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    trace, K.TRACE = K.TRACE, None
    a_rows, b_rows, bmins, widths, params = grouped["args"][:5]
    results, metrics = grouped["out"]
    shapes = kernel_classes(trace, sm_clock_mhz, "method 4")
    dev_ms = sum(c["device_ms"] for c in shapes)
    log(
        f"method 4 real size: {sel.stop} candidates, {len(a_rows)} bands aligned, "
        f"{st.count} alignments kept; {secs:.2f}s, of which align4_bands (host) "
        f"{bands_s[0]:.2f}s; launches {launches}, kernel device time {dev_ms:.1f} ms"
    )
    if launches["banded_fwd"] == 0 or launches["banded_tb"] == 0 or st.count == 0:
        raise AssertionError(f"method 4 real size: launches {launches}, kept {st.count}")
    # 128 seeded tasks through the grouped route with the plain version.
    pick = np.sort(np.random.default_rng(8).choice(len(a_rows), min(128, len(a_rows)), replace=False))
    t0 = time.perf_counter()
    with plain_kernels():
        sub, sub_met = AL._grouped_run(
            [a_rows[i] for i in pick], [b_rows[i] for i in pick], bmins[pick],
            widths[pick], params, device="cuda",
        )
    for t, i in enumerate(pick):
        if not (np.array_equal(sub[t][0], results[i][0])
                and np.array_equal(sub[t][1], results[i][1])
                and np.array_equal(sub_met[t], metrics[i])):
            raise AssertionError(f"method 4 real size: task {i} differs from the plain version")
    log(
        f"method 4 spot check: {pick.shape[0]} tasks identical under the plain version "
        f"on the card ({time.perf_counter() - t0:.1f}s)"
    )
    return {"candidates": sel.stop, "tasks": len(a_rows), "kept": st.count,
            "seconds": secs, "align4_bands_s": bands_s[0], "launches": launches,
            "shapes": shapes, "device_ms": dev_ms}


def phase_iterative(work):
    """Phase 7 (c): tests/test_iterative.py's input (20 kb genome, seed 71,
    120 reads of 3 kb, 2 iterations) on the card and on the CPU: every
    stage manifest and the FASTA/GFA equal."""
    from shasta_tpu_torch.utils import synth

    fasta = os.path.join(work, "iterative.fasta")
    genome = synth.random_genome(20000, seed=71)
    synth.write_fasta(fasta, synth.sample_reads(genome, 120, 3000, seed=72, both_strands=True))
    _, conf = golden_inputs(work)
    runs = {}
    for label, device in (("iterative-cuda", "cuda"), ("iterative-cpu", "cpu")):
        run_dir, summary, launches, secs = run_cli(
            label, work,
            ["--config", conf, "--input", fasta, "--device", device, *SMALL_OVERRIDES,
             "--Assembly.iterative", "true", "--Assembly.iterative.iterationCount", "2"],
        )
        check_card_launches(label, device, None, launches)
        if "iterativeAssembly-1" not in summary["stageSeconds"]:
            raise AssertionError(f"{label}: the second refinement round did not run")
        runs[device] = (stage_hashes(run_dir), file_hashes(run_dir, OUTPUTS))
        log(
            f"iterative assemble --device {device}: {secs:.2f}s, "
            f"{summary['assembledSegmentCount']} segments, "
            f"{summary['totalAssembledSegmentLength']} bases, launches {launches}"
        )
    if runs["cuda"] != runs["cpu"]:
        raise AssertionError("iterative: stage manifests or FASTA/GFA differ card/CPU")
    log("iterative: every stage manifest and the FASTA/GFA equal on the card and the CPU")


# Mode 3's test inputs (tests/test_torch_mode3.py): (genome seed, reads,
# read length, read seed, error rate, minHashIterationCount or None for
# small_config's 6). "pathgraph" is test_pathgraph_on_pipeline_mode3's;
# "noisy" (tests/test_mode3.py's 2% error input) is the one whose
# Jaccard graph has edges and paths.
MODE3_INPUTS = {
    "pathgraph": (55, 120, 2500, 56, 0.0, None),
    "noisy": (91, 160, 3000, 92, 0.02, 20),
}
MODE3_VALUES = [
    "mode3SegmentCount", "mode3LinkCount", "mode3PathCount",
    "mode3JaccardEdgeCount", "mode3JaccardPathCount",
    "mode3JaccardPathTotalLength", "mode3JaccardPathN50", "mode3ClusterCount",
]
MODE3_FILES = ["Mode3-Assembly.gfa", "JaccardGraphEdges.csv", "Mode3-Paths.fasta"]
# write_output's files that hold no timing and do not name the package.
WRITE_OUTPUT_FILES = OUTPUTS + [
    "shasta.conf", "stdout.log", "ReadLengthHistogram.csv",
    "LowHashBucketHistogram.csv", "ReadLowHashStatistics.csv",
]


def overrides_with(base, flag, value):
    """``base`` --Section.key overrides with ``flag`` set to ``value``."""
    out = list(base)
    if flag in out:
        out[out.index(flag) + 1] = value
    else:
        out += [flag, value]
    return out


def phase_mode3_test_inputs(work):
    """Phase 8 (a): mode 3 through the assemble command on the test
    inputs, on the card and on the CPU: every stage manifest (MarkerGraph
    and Mode3 included), the three mode-3 files, write_output's files and
    the eight mode3* values equal."""
    from shasta_tpu_torch.utils import synth

    _, conf = golden_inputs(work)
    out = {}
    for name, (gseed, n, length, rseed, err, iters) in MODE3_INPUTS.items():
        fasta = os.path.join(work, f"mode3-{name}.fasta")
        genome = synth.random_genome(20000, seed=gseed)
        synth.write_fasta(
            fasta, synth.sample_reads(genome, n, length, seed=rseed, error_rate=err,
                                      both_strands=True),
        )
        argv = overrides_with(SMALL_OVERRIDES, "--Assembly.mode", "3")
        if iters is not None:
            argv = overrides_with(argv, "--MinHash.minHashIterationCount", str(iters))
        runs = {}
        for device in ("cuda", "cpu"):
            label = f"mode3-{name}-{device}"
            run_dir, summary, launches, secs = run_cli(
                label, work, ["--config", conf, "--input", fasta, "--device", device, *argv]
            )
            check_card_launches(label, device, None, launches)
            hashes = stage_hashes(run_dir)
            if not {"MarkerGraph", "Mode3"} <= set(hashes):
                raise AssertionError(f"{label}: stages {sorted(hashes)}")
            hashes.update(file_hashes(run_dir, MODE3_FILES + WRITE_OUTPUT_FILES))
            values = {k: summary[k] for k in MODE3_VALUES}
            runs[device] = (hashes, values)
            out[label] = {"seconds": secs, "launches": launches, **values}
            log(f"mode 3 {name} assemble --device {device}: {secs:.2f}s, {values}, "
                f"launches {launches}")
        if runs["cuda"] != runs["cpu"]:
            bad = sorted(k for k in runs["cpu"][0] if runs["cuda"][0].get(k) != runs["cpu"][0][k])
            raise AssertionError(f"mode 3 {name}: card != CPU: {bad}, {runs}")
        if name == "noisy" and runs["cpu"][1]["mode3JaccardPathCount"] == 0:
            raise AssertionError("mode 3 noisy: no Jaccard path")
    log(
        "mode 3 test inputs: every stage manifest, the three mode-3 files, "
        "write_output's files and the eight mode3* values equal on the card and the CPU"
    )
    return out


def phase_mode3_real_size(work, sm_clock_mhz, genome_len=1_000_000):
    """Phase 8 (b): mode 3 at a real size on the card: a 1 Mb random
    genome (seed 700), ONT-like reads at 25x (seed 701, phase 4's length
    model), Nanopore-May2022 verbatim plus --Assembly.mode 3. 1 Mb and
    not 2: the mode-3 host stages grow faster than the genome, about 200
    s at 2 Mb by a CPU rehearsal (PERF.md), past this phase's share of
    the script's time. Launch counts reset
    just before the run and read just after; 128 kept pairs re-aligned
    with the plain version on the card; Mode3-Paths.fasta graded against
    the genome. It fails if no Jaccard path is assembled."""
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.pipeline.assemble import run_assembly
    from shasta_tpu_torch.pipeline.config import AssemblyConfig
    from shasta_tpu_torch.pipeline.configurations import get_configuration
    from shasta_tpu_torch.utils import synth

    t0 = time.perf_counter()
    genome = synth.random_genome(genome_len, seed=700)
    reads = synth.sample_reads_ont(
        genome, 25.0, seed=701, median_length=25000, sigma=0.55, min_length=3000
    )
    fasta = os.path.join(work, "mode3.fasta")
    synth.write_fasta(fasta, reads)
    log(
        f"mode 3 real size: a {genome_len / 1e6:.1f} Mb genome, {len(reads)} reads, "
        f"{sum(r.shape[0] for r in reads) / 1e6:.1f} Mb, generated in "
        f"{time.perf_counter() - t0:.1f}s"
    )
    del reads
    cfg = AssemblyConfig.from_conf_text(get_configuration("Nanopore-May2022"))
    cfg.assembly.mode = 3
    run_dir = os.path.join(work, "mode3")

    reset_launches()
    K.TRACE = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with waves_env(None), contextlib.redirect_stdout(io.StringIO()):
        summary = run_assembly([fasta], run_dir, cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    trace, K.TRACE = K.TRACE, None
    peak = torch.cuda.max_memory_allocated()
    times = summary["stageSeconds"]
    values = {k: summary[k] for k in MODE3_VALUES}
    log(f"mode 3 real size run_assembly: {wall:.2f}s wall; stage seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    log(
        f"mode 3 real size: reads {summary['readCount']}, candidates "
        f"{summary['alignmentCandidateCount']}, alignments {summary['alignmentCount']}; "
        f"markerGraphMinCoverageUsed {summary['markerGraphMinCoverageUsed']}, marker graph "
        f"vertices {summary['markerGraphVertexCount']}, edges "
        f"{summary['markerGraphEdgeCount']}; {values}"
    )
    shapes = kernel_classes(trace, sm_clock_mhz, "mode 3")
    fwd_ms = sum(c["device_ms"] for c in shapes if c["kernel"] != "banded_tb")
    tb_ms = sum(c["device_ms"] for c in shapes if c["kernel"] == "banded_tb")
    dp_wall = times["flagPalindromicReads"] + times["computeAlignments"]
    log(
        f"mode 3 real size launches: {launches}; peak device memory "
        f"{peak / 2**30:.2f} GiB; kernel device time fwd {fwd_ms:.1f} ms, tb "
        f"{tb_ms:.1f} ms, busy {(fwd_ms + tb_ms) / 1e3 / dp_wall:.1%} of the two DP "
        f"stages' {dp_wall:.2f}s"
    )
    if launches["banded_fwd"] == 0 or launches["banded_tb"] == 0:
        raise AssertionError(f"mode 3 real size: a kernel never launched: {launches}")
    if values["mode3JaccardPathCount"] < 1:
        raise AssertionError(f"mode 3 real size: no Jaccard path assembled: {values}")
    paths = os.path.join(run_dir, "Mode3-Paths.fasta")
    spot_check_later("mode 3 real size", run_dir, cfg)
    return {
        "genome_len": genome_len, "launches": launches, "times": times, "wall_s": wall,
        "peak_bytes": peak,
        "summary": {k: v for k, v in summary.items() if not isinstance(v, (dict, list))},
        "paths_fasta": dict(zip(("sequences", "total", "n50"), fasta_stats(paths))),
        "grade": grade("mode 3 real size", paths, genome),
        "shapes": shapes, "fwd_ms": fwd_ms, "tb_ms": tb_ms,
    }


# The downsampling hash table of every k-mer, by k: a function of k alone,
# built once in the spot-check worker; the seconds numpy took, by k.
_DS_TABLES = {}
_DS_SECONDS = {}

# The spot-check worker (spot_checks_start) and its pending checks.
_SPOT = {"pool": None, "pending": []}


def ont_k():
    """Nanopore-May2022's k-mer length (the real-size runs' k)."""
    from shasta_tpu_torch.pipeline.config import AssemblyConfig
    from shasta_tpu_torch.pipeline.configurations import get_configuration

    return AssemblyConfig.from_conf_text(get_configuration("Nanopore-May2022")).kmers.k


def _spot_worker_init(k):
    from shasta_tpu_torch.data.kmers import kmer_downsampling_hash

    t0 = time.perf_counter()
    _DS_TABLES[k] = kmer_downsampling_hash(np.arange(1 << (2 * k), dtype=np.uint64), k)
    _DS_SECONDS[k] = time.perf_counter() - t0


def _ds_table_digest(k):
    """(sha256 of the worker's numpy table of k, the seconds numpy took
    to build it)."""
    return hashlib.sha256(memoryview(_DS_TABLES[k])).hexdigest(), _DS_SECONDS[k]


def spot_checks_start():
    """Start the process that runs the spot checks of phases 4, 6 and 8
    (spawned, with its own CUDA context; it builds the 4^k downsampling
    table first). The plain version's row loop is host-bound and takes
    minutes a run, so the checks run beside the phases that follow;
    spot_checks_finish collects them."""
    import multiprocessing as mp

    _SPOT["pool"] = mp.get_context("spawn").Pool(1, _spot_worker_init, (ont_k(),))


def _spot_check_task(label, run_dir, cfg):
    from shasta_tpu_torch.data.kmers import KmerTable
    from shasta_tpu_torch.data.markers import MarkerStore
    from shasta_tpu_torch.data.store import RunStore
    from shasta_tpu_torch.ops import align as AL

    store = RunStore(run_dir, create=False)
    lines = []
    spot_check(
        label, MarkerStore.from_arrays(store.load_stage("Markers")),
        KmerTable.from_arrays(store.load_stage("Kmers")),
        AL.AlignmentStore.from_arrays(store.load_stage("Alignments")), _align_params(cfg),
        say=lines.append,
    )
    return lines


def spot_check_later(label, run_dir, cfg):
    """Queue spot_check on the run in ``run_dir`` in the spot-check worker."""
    _SPOT["pending"].append(
        _SPOT["pool"].apply_async(_spot_check_task, (label, run_dir, cfg))
    )


def spot_checks_finish():
    """Wait for every queued spot check, print its lines; a check that
    failed raises here."""
    t0 = time.perf_counter()
    for r in _SPOT["pending"]:
        for line in r.get():
            log(line)
    _SPOT["pending"] = []
    log(f"spot checks: waited {time.perf_counter() - t0:.1f}s for the worker")


def spot_checks_stop():
    """End the spot-check worker."""
    if _SPOT["pool"] is not None:
        _SPOT["pool"].terminate()
        _SPOT["pool"].join()
        _SPOT["pool"] = None


def spot_check(label, markers, kmer_table, aligned, params, say=log):
    """127 seeded kept pairs plus the longest of a run's Alignments,
    re-aligned with the plain version on the card under AlignParams
    ``params``: identical ordinals. ``say`` takes the lines it reports."""
    from shasta_tpu_torch.ops import align as AL
    from shasta_tpu_torch.ops import align_kernel as K

    rng = np.random.default_rng(7)
    longest = int(np.argmax(aligned.n_markers0 + aligned.n_markers1))
    pick = np.unique(np.concatenate([
        rng.choice(aligned.count, min(127, aligned.count), replace=False), [longest]
    ]))
    ts = time.perf_counter()
    if kmer_table.k not in _DS_TABLES:
        _DS_TABLES[kmer_table.k] = kmer_table.downsampling_hash_table()
        say(f"downsampling hash table built on the host in {time.perf_counter() - ts:.2f}s")
    ds_table = _DS_TABLES[kmer_table.k]
    ts = time.perf_counter()
    with plain_kernels():
        sub = AL.align_candidates(
            markers, aligned.read_id0[pick], aligned.read_id1[pick],
            aligned.same_strand[pick], params, ds_table, device="cuda",
        )
    if sub.count != pick.shape[0]:
        raise AssertionError(f"{label} spot check kept {sub.count} of {pick.shape[0]}")
    for t, i in enumerate(pick):
        a0, a1 = aligned.ordinals(int(i))
        b0, b1 = sub.ordinals(t)
        if not (np.array_equal(a0, b0) and np.array_equal(a1, b1)):
            raise AssertionError(f"{label} spot check: pair {i} differs from the plain version")
    say(
        f"{label} spot check: {pick.shape[0]} kept pairs (longest "
        f"{int(aligned.n_markers0[longest])}+{int(aligned.n_markers1[longest])} markers) "
        f"identical under the plain version on the card ({time.perf_counter() - ts:.1f}s)"
    )


@contextlib.contextmanager
def plain_kernels():
    """banded_align_pairs replaced by its plain version for the duration
    (the comparisons' launches then count nowhere)."""
    from shasta_tpu_torch.ops import align_kernel as K

    real = K.banded_align_pairs
    K.banded_align_pairs = K.banded_align_pairs_plain
    try:
        yield
    finally:
        K.banded_align_pairs = real


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
# Phase 9: the mesh
# ---------------------------------------------------------------------------
#
# The rank bodies below run in processes that
# shasta_tpu_torch.parallel.distributed.spawn starts (they import this
# file as a module, so they are defined at its top level); each returns
# host values.


def u32_mix(x, seed):
    """The JAX package's uint32 mixer (parallel/mesh.py:_mix64) in numpy,
    whose uint32 arithmetic wraps."""
    h = x.astype(np.uint32) ^ np.uint32(seed & 0xFFFFFFFF)
    h = (h ^ (h >> np.uint32(16))) * np.uint32(0x7FEB352D)
    h = (h ^ (h >> np.uint32(15))) * np.uint32(0x846CA68B)
    return h ^ (h >> np.uint32(16))


def hooking_rounds_host(n, u, v, rounds, jumps):
    """parallel/mesh.py's min-hooking rounds on one host, in numpy."""
    label = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        lu, lv = label[u], label[v]
        prop = label.copy()
        np.minimum.at(prop, np.maximum(lu, lv), np.minimum(lu, lv))
        label = prop
        for _ in range(jumps):
            label = label[label]
    return label


def mesh_checks_rank(mesh, golden_run):
    """Phase 9 (a) on one rank: every sharded function of parallel/mesh.py
    on seeded inputs against its host function (the plain DP on the card
    for the alignment wrappers); the names of those checked, with the
    launch counts (from 0) and the collectives."""
    from shasta_tpu_torch.data.markers import MarkerStore
    from shasta_tpu_torch.data.store import RunStore
    from shasta_tpu_torch.graph.marker_graph import union_find_labels
    from shasta_tpu_torch.ops import align as AL
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.ops import lowhash as LH
    from shasta_tpu_torch.parallel import mesh as M

    reset_launches()
    dev = mesh.device
    rng = np.random.default_rng(900)
    done = []

    def check(name, ok):
        if not ok:
            raise AssertionError(f"mesh {name} differs from its host function")
        done.append(name)

    # LowHash step: 65,536 reads of m = 4 features.
    feats = rng.integers(0, 2**32, (1 << 16, 4), dtype=np.uint32)
    h, bucket, hist = M.fetch_tree(M.sharded_lowhash_step(mesh, feats, 5, 12))
    ref = np.zeros(feats.shape[0], np.uint32)
    for j in range(4):
        ref = u32_mix(feats[:, j] ^ ref, 5 * 37 + j)
    check("sharded_lowhash_step", np.array_equal(h, ref) and np.array_equal(
        bucket, ref & 4095) and np.array_equal(hist, np.bincount(ref & 4095, minlength=4096)))
    # Candidates on the golden run's Markers, small_config's LowHash.
    markers = MarkerStore.from_arrays(RunStore(golden_run, create=False).load_stage("Markers"))
    params = LH.LowHashParams(m=4, hash_fraction=0.05, iteration_count=6, max_bucket_size=60)
    host = LH.find_candidates_lowhash(markers, params)
    shard = M.sharded_find_candidates(mesh, markers, params)
    check("sharded_find_candidates", host.count == shard.count > 0 and all(
        np.array_equal(getattr(host, f), getattr(shard, f))
        for f in ("read_id0", "read_id1", "same_strand", "frequency")))
    # Union-find on 2^20 items and 2^21 random edges.
    n = 1 << 20
    u = rng.integers(0, n, 1 << 21).astype(np.int32)
    v = rng.integers(0, n, 1 << 21).astype(np.int32)
    raw = M.fetch(M.sharded_union_find(mesh, n, u, v, n_rounds=3))
    check("sharded_union_find", np.array_equal(raw, hooking_rounds_host(n, u, v, 3, 8)))
    check("sharded_union_find_labels", np.array_equal(
        M.sharded_union_find_labels(mesh, n, u, v), union_find_labels(n, u, v)))
    # The alignment wrappers: 64 pairs at LA 1024 x W 128 (60 real, padded).
    LA, W = 1024, 128
    a, a_len, b, b_len, bm = make_batch(901, 64, LA, W)
    a_len[60:] = 0
    b_len[60:] = 0
    args = [torch.from_numpy(x).to(dev) for x in (a, a_len, b, b_len, bm)]
    kw = dict(LA=LA, LB=LA, W=W, match=6, mismatch=-1, gap=-1)
    plain = K.banded_align_pairs_plain(*args, **kw)
    check("sharded_pallas_align", torch.equal(
        M.sharded_pallas_align(mesh, a, a_len, b, b_len, bm, **kw), plain))
    check("sharded_forward_traceback", torch.equal(M.sharded_forward_traceback(
        mesh, a, a_len, b, b_len, bm, W=W, match=6, mismatch=-1, gap=-1), plain))
    pa = K.prepare_inputs(*args, LA=LA, LB=LA, W=W)
    _d, best, bi, bd = K.banded_fwd_plain(*pa, **kw)
    got = M.sharded_banded_forward(mesh, a, a_len, b, b_len, bm, W=W)
    check("sharded_banded_forward", all(torch.equal(x, y) for x, y in zip(got, (bi, bd, best))))
    # The take feed and the band reduction on a CSR of pairs 1 to 59's
    # rows (every row in the length class LA).
    rows = [a[t, : a_len[t]] for t in range(1, 60)] + [b[t, : b_len[t]] for t in range(1, 60)]
    lens = np.array([r.shape[0] for r in rows], np.int64)
    off = np.concatenate(([0], np.cumsum(lens)))
    aux = np.concatenate([np.sort(rng.choice(4 * int(x), int(x), replace=False)) for x in lens])
    csr = AL._DeviceCsr(np.concatenate(rows), off, lens, dev, aux=aux.astype(np.int32))
    ia, ib = np.arange(59), np.arange(59, 118)
    ra, rb = csr.local[ia], csr.local[ib]
    ma, mb = csr.matrix(LA), csr.matrix(LA)
    al, bl = lens[ia].astype(np.int32), lens[ib].astype(np.int32)
    tbm = bm[1:60]
    pt = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (ra, rb, al, bl, tbm)]
    fused = K.banded_align_pairs_plain(
        AL._take_rows(ma, pt[0], pt[2], -1), pt[2], AL._take_rows(mb, pt[1], pt[3], -2),
        pt[3], pt[4], **kw)
    check("sharded_align_take", torch.equal(
        M.sharded_align_take(mesh, ma, ra, mb, rb, al, bl, tbm, **kw), fused))
    oa, ob = csr.aux_matrix(LA), csr.aux_matrix(LA)
    band = K.band_reduce(
        fused[:, 16:], AL._take_rows(oa, pt[0], pt[2], 0), AL._take_rows(ob, pt[1], pt[3], 0))
    check("sharded_band_take", torch.equal(
        M.sharded_band_take(mesh, ma, ra, oa, mb, rb, ob, al, bl, tbm, **kw), band))
    # full_step on 4,096 features, the batch, and 2^16 edges on 2^14 items.
    eu = rng.integers(0, 1 << 14, 1 << 16).astype(np.int32)
    ev = rng.integers(0, 1 << 14, 1 << 16).astype(np.int32)
    fhist, fbest, flabel = M.fetch_tree(M.full_step(
        mesh, feats[:4096], a, a_len, b, b_len, bm, eu, ev, 1 << 14, W=W, log2_buckets=8))
    ref = np.zeros(4096, np.uint32)
    for j in range(4):
        ref = u32_mix(feats[:4096, j] ^ ref, 37 + j)
    check("full_step", np.array_equal(fhist, np.bincount(ref & 255, minlength=256))
          and np.array_equal(fbest, best.cpu().numpy())
          and np.array_equal(flabel, hooking_rounds_host(1 << 14, eu, ev, 8, 2)))
    return {"checks": done, "launches": dict(K.LAUNCHES), "calls": dict(mesh.calls),
            "seconds": dict(mesh.seconds)}


def golden_distributed_rank(mesh, work):
    """Phase 9 (b) on one rank: run_assembly_distributed on the golden
    inputs of modes 0 and 2 (rank 0 writes the run directory, the others
    .process{rank}); launch counts from 0 for the two runs."""
    from shasta_tpu_torch.__main__ import _apply_overrides
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.parallel.distributed import run_assembly_distributed
    from shasta_tpu_torch.pipeline.config import AssemblyConfig

    reset_launches()
    out = {}
    for mode, fasta, overrides in (
        (0, "golden.fasta", SMALL_OVERRIDES), (2, "golden-mode2.fasta", MODE2_OVERRIDES),
    ):
        cfg = _apply_overrides(AssemblyConfig(), list(overrides))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = run_assembly_distributed(
                [os.path.join(work, fasta)], os.path.join(work, f"mesh2-mode{mode}"), cfg,
                device=mesh.device, backend=mesh.backend,
            )
        out[mode] = {"seconds": time.perf_counter() - t0, "summary": summary}
    out["launches"] = dict(K.LAUNCHES)
    return out


def real_size_rank(mesh, fasta, run_dir, sm_clock_mhz):
    """Phase 9 (c) on one rank: phase 4's run on the mesh (rank 0 writes
    ``run_dir``, the others .process{rank}, as run_assembly_distributed
    does); launch counts from 0 just before, read just after, with the
    launch trace, peak device memory and the collectives' seconds."""
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.pipeline.assemble import run_assembly
    from shasta_tpu_torch.pipeline.config import AssemblyConfig
    from shasta_tpu_torch.pipeline.configurations import get_configuration

    cfg = AssemblyConfig.from_conf_text(get_configuration("Nanopore-May2022"))
    if mesh.rank:
        run_dir = os.path.join(run_dir, f".process{mesh.rank}")
    reset_launches()
    K.TRACE = []
    torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    with waves_env(None), contextlib.redirect_stdout(io.StringIO()):
        summary = run_assembly([fasta], run_dir, cfg, mesh=mesh)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    trace, K.TRACE = K.TRACE, None
    torch.cuda.synchronize(mesh.device)
    shapes = kernel_classes(trace, sm_clock_mhz, f"rank {mesh.rank}", echo=False)
    return {
        "rank": mesh.rank, "wall_s": wall, "times": summary["stageSeconds"],
        "launches": launches, "shapes": shapes,
        "fwd_ms": sum(c["device_ms"] for c in shapes if c["kernel"] == "banded_fwd"),
        "tb_ms": sum(c["device_ms"] for c in shapes if c["kernel"] == "banded_tb"),
        "peak_bytes": torch.cuda.max_memory_allocated(mesh.device),
        "exchange_s": dict(mesh.seconds), "exchange_calls": dict(mesh.calls),
        "segments": summary["assembledSegmentCount"],
        "alignments": summary["alignmentCount"],
    }


def phase_mesh(work, real, sm_clock_mhz):
    """Phase 9: the mesh on the card. (a) every sharded function on a
    one-rank NCCL world against its host function, then
    dryrun_multichip(1); (b) run_assembly_distributed on two gloo ranks
    that share the card, on the golden inputs of modes 0 and 2: every
    golden value in both ranks' run directories; (c) phase 4's 5 Mb run on
    two gloo ranks that share the card: Assembly.fasta and Assembly.gfa
    byte-equal to phase 4's."""
    from shasta_tpu_torch.entry import dryrun_multichip
    from shasta_tpu_torch.parallel.distributed import spawn

    torch.cuda.empty_cache()
    out = {}
    t0 = time.perf_counter()
    (a,) = spawn(mesh_checks_rank, 1, device="cuda", args=(os.path.join(work, "golden-cuda"),),
                 timeout=600)
    if a["launches"]["banded_fwd"] == 0 or a["launches"]["banded_tb"] == 0:
        raise AssertionError(f"mesh (a): a kernel never launched: {a['launches']}")
    log(f"mesh (a) one NCCL rank: {', '.join(a['checks'])} equal to the host functions; "
        f"launches {a['launches']}; collectives {a['calls']}; {time.perf_counter() - t0:.1f}s")
    t1 = time.perf_counter()
    line = dryrun_multichip(1, device="cuda", timeout=600)
    out["a"] = {**a, "dryrun": line, "seconds": time.perf_counter() - t0,
                "dryrun_s": time.perf_counter() - t1}
    log(f"mesh (a) dryrun_multichip(1) on the card: {time.perf_counter() - t1:.1f}s")

    t0 = time.perf_counter()
    ranks = spawn(golden_distributed_rank, 2, device="cuda", backend="gloo", args=(work,),
                  timeout=600)
    with open(GOLDEN) as f:
        pinned0 = json.load(f)
    with open(GOLDEN_MODE2) as f:
        pinned2 = json.load(f)
    with open(GOLDEN_METRICS) as f:
        metrics = json.load(f)
    for mode, pinned in ((0, pinned0), (2, pinned2)):
        run_dir = os.path.join(work, f"mesh2-mode{mode}")
        for d in (run_dir, os.path.join(run_dir, ".process1")):
            got = stage_hashes(d)
            got.update(file_hashes(d, [k[5:] for k in pinned if k.startswith("file:")]))
            bad = sorted(k for k in pinned if got.get(k) != pinned[k])
            if bad:
                raise AssertionError(f"mesh (b) mode {mode} {d}: golden values differ: {bad}")
        summary = ranks[0][mode]["summary"]
        if ranks[1][mode]["summary"] is not None:
            raise AssertionError("mesh (b): rank 1 returned a summary")
        if mode == 0 and {k: summary[k] for k in GOLDEN_KEYS} != metrics:
            raise AssertionError(f"mesh (b): metrics differ from mode0_metrics.json")
        for name in OUTPUTS if mode == 0 else []:
            with open(os.path.join(run_dir, name), "rb") as f, open(
                os.path.join(work, "golden-cuda", name), "rb"
            ) as g:
                if f.read() != g.read():
                    raise AssertionError(f"mesh (b): {name} differs from phase 3's")
    launches = {k: ranks[0]["launches"][k] + ranks[1]["launches"][k] for k in ranks[0]["launches"]}
    if launches["banded_fwd"] == 0 or launches["banded_tb"] == 0:
        raise AssertionError(f"mesh (b): a kernel never launched: {launches}")
    out["b"] = {"launches": launches, "seconds": time.perf_counter() - t0,
                "ranks": [{m: r[m]["seconds"] for m in (0, 2)} for r in ranks]}
    log(f"mesh (b) two gloo ranks on the card: modes 0 and 2 give every golden value "
        f"(both ranks' directories), mode 0's files byte-equal to phase 3's; launches "
        f"{launches} (rank 0 {ranks[0]['launches']}); {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    run_dir = os.path.join(work, "ont5mb-mesh2")
    ranks = spawn(real_size_rank, 2, device="cuda", backend="gloo",
                  args=(os.path.join(work, "ont5mb.fasta"), run_dir, sm_clock_mhz), timeout=900)
    wall = time.perf_counter() - t0
    for name in ("Assembly.fasta", "Assembly.gfa"):
        for d in (run_dir, os.path.join(run_dir, ".process1")):
            with open(os.path.join(d, name), "rb") as f, open(
                os.path.join(real["dir"], name), "rb"
            ) as g:
                if f.read() != g.read():
                    raise AssertionError(f"mesh (c): {d}/{name} differs from phase 4's")
    for r in ranks:
        if r["launches"]["banded_fwd"] == 0 or r["launches"]["banded_tb"] == 0:
            raise AssertionError(f"mesh (c) rank {r['rank']}: a kernel never launched")
        ex = r["exchange_s"]
        log(
            f"mesh (c) rank {r['rank']}: run_assembly {r['wall_s']:.2f}s; stage seconds: "
            + ", ".join(f"{k} {v:.2f}" for k, v in r["times"].items())
        )
        log(
            f"mesh (c) rank {r['rank']}: launches {r['launches']}; kernel device time fwd "
            f"{r['fwd_ms']:.1f} ms, tb {r['tb_ms']:.1f} ms; peak device memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; exchange {sum(ex.values()):.2f}s ("
            + ", ".join(f"{k} {v:.2f}s in {r['exchange_calls'][k]}" for k, v in ex.items())
            + ")"
        )
        for c in r["shapes"]:
            log(f"  [rank {r['rank']}] {c['kernel']} ({c['body']}) LA={c['LA']} W={c['W']}: "
                f"{c['launches']} launches, {c['pairs']} pairs, {c['device_ms']:.2f} ms")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    out["c"] = {"wall_s": wall, "launches": launches, "ranks": ranks}
    log(f"mesh (c) two gloo ranks on the card, 5 Mb: {wall:.2f}s wall (spawn included); "
        f"Assembly.fasta and Assembly.gfa byte-equal to phase 4's in both ranks' "
        f"directories; launches {launches}")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the explorer
# ---------------------------------------------------------------------------


# tests/test_cli.py:test_assemble_cli_end_to_end's explorer paths.
EXPLORER_PATHS = [
    "/", "/read?readId=0&strand=0", "/alignments?readId=0",
    "/read?readId=read-0&strand=0", "/readGraph?readId=0", "/markerGraph?vertexId=0",
    "/localReadGraph?readId=0&strand=0", "/localMarkerGraph?vertexId=0&maxDistance=2",
    "/localMarkerGraph?vertexId=0&maxDistance=2&label=sequence&color=distance",
    "/alignmentMatrix?readId0=0&readId1=1", "/assemblyGraph?segment=0&maxDistance=2",
    "/alignment?readId0=0&strand0=0&readId1=1&strand1=0",
    "/blastRead?readId=0&strand=0&beginPosition=0&endPosition=400",
    "/exploreAlignmentCoverage?readId=0&strand=0", "/computeAllAlignments?readId=0",
    "/exploreAlignmentCandidateGraph?readId=0", "/exploreAlignmentGraph?readId=0",
    "/alignSequencesInBaseRepresentation?sequence0=ACGTACGT&sequence1=ACGGACGT",
    "/assessAlignments", "/markerGraphEdge?edgeId=0",
    "/exploreMarkerCoverage?readId=0&strand=0", "/inducedAlignment?readId0=0&readId1=1",
    "/followReadInMarkerGraph?readId=0&strand=0",
    "/exploreMarkerConnectivity?readId=0&strand=0&ordinal=0",
    "/assemblyGraphEdge?edgeId=0", "/exploreAssemblyGraphEdgesSupport?edgeId=0",
    "/compressedAssemblyGraph?edgeId=0", "/assemblySummary.json",
]
# tests/test_mode3.py:test_mode3_pipeline's mode-3 pages.
MODE3_PAGES = [
    "/mode3?segmentId=0", "/mode3Segment?segmentId=0",
    "/mode3SegmentPair?segmentId0=0&segmentId1=1", "/mode3Link?linkId=0",
    "/mode3MetaAlignment?readId0=0&readId1=1", "/mode3AssemblyPath?segmentId=0",
    "/mode3LinkAssembly?linkId=0",
]


def phase_explorer(work):
    """Phase 10: the explorer on the card over phase 3's golden run and
    phase 8a's noisy mode-3 run: every page GETs 200, and the on-demand
    alignment of a stored alignment's two reads launches the kernels
    (counts from 0 just before the pages, read just after)."""
    import urllib.request
    from http.server import HTTPServer

    from shasta_tpu_torch.data.store import RunStore
    from shasta_tpu_torch.http.explore import Explorer, make_handler
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.ops.align import AlignmentStore

    out = {}
    for label, run, pages in (
        ("golden", "golden-cuda", EXPLORER_PATHS), ("mode3", "mode3-noisy-cuda", MODE3_PAGES),
    ):
        run_dir = os.path.join(work, run)
        al = AlignmentStore.from_arrays(RunStore(run_dir, create=False).load_stage("Alignments"))
        on_demand = (
            f"/alignment?readId0={int(al.read_id0[0])}&strand0=0&readId1="
            f"{int(al.read_id1[0])}&strand1={0 if al.same_strand[0] else 1}"
        )
        server = HTTPServer(("127.0.0.1", 0), make_handler(Explorer(run_dir)))
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        reset_launches()
        t0 = time.perf_counter()
        try:
            for path in pages + [on_demand]:
                url = f"http://127.0.0.1:{server.server_address[1]}{path}"
                with urllib.request.urlopen(url, timeout=120) as r:
                    body = r.read()
                    if r.status != 200 or not body:
                        raise AssertionError(f"explorer {label} {path}: {r.status}")
        finally:
            server.shutdown()
            server.server_close()
            t.join()
        launches = dict(K.LAUNCHES)
        if b"aligned markers" not in body or launches["banded_tb"] == 0:
            raise AssertionError(f"explorer {label}: on-demand alignment {launches}, {body[:200]}")
        out[label] = {"pages": len(pages) + 1, "launches": launches,
                      "seconds": time.perf_counter() - t0}
        log(f"explorer {label}: {len(pages) + 1} pages 200 on the card "
            f"({time.perf_counter() - t0:.2f}s), launches {launches}")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the stage drivers
# ---------------------------------------------------------------------------

SCRIPTS = os.path.join(ROOT, "shasta_tpu_torch", "scripts")


def run_script(name, argv, waves=None):
    """shasta_tpu_torch/scripts/<name>.py's main(argv) in this process, its
    launch counts from 0 just before and read just after: (exit code,
    stdout, launches, launch trace, wall seconds)."""
    from shasta_tpu_torch.ops import align_kernel as K

    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    import _common

    main = _common.load(name).main
    out = io.StringIO()
    reset_launches()
    K.TRACE = []
    t0 = time.perf_counter()
    with waves_env(waves), contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    trace, K.TRACE = K.TRACE, None
    return rc, out.getvalue(), dict(K.LAUNCHES), trace, secs


def phase_scripts_golden(work):
    """Phase 11a: the kernel-reaching drivers on two copies of phase 3's
    golden run, on the card and with --device cpu."""
    import shutil

    from shasta_tpu_torch.data.store import RunStore

    src = os.path.join(work, "golden-cuda")
    with open(GOLDEN) as f:
        pinned = json.load(f)
    al = RunStore(src, create=False).load_stage("Alignments")
    pair = [str(int(al["read_id0"][0])), "0", str(int(al["read_id1"][0])),
            "0" if al["same_strand"][0] else "1"]
    # (driver, arguments after the run directory, SHASTA_TORCH_WAVES, the
    # stages it rewrites, whether it runs the DP); Test.py opens no run.
    steps = [
        ("ComputeAlignments", [], None, ["Alignments"], True),
        ("ComputeAlignments", [], "2", ["Alignments"], True),
        ("FlagPalindromicReads", [], None, ["Reads"], True),
        ("FindAlignmentCandidatesLowHash0", [], None, ["AlignmentCandidates"], False),
        ("AlignOrientedReads", pair, None, [], True),
        ("AlignOrientedReads4", pair, None, [], True),
        ("Mode0Assembly", [], None, [], False),
        ("Test", None, None, [], False),
    ]
    runs = {}
    for device in ("cuda", "cpu"):
        run_dir = os.path.join(work, f"scripts-golden-{device}")
        shutil.copytree(src, run_dir)
        for name, extra, waves, rewrites, dp in steps:
            if device == "cpu" and waves:
                continue
            label = f"{name}{' SHASTA_TORCH_WAVES=' + waves if waves else ''} --device {device}"
            argv = ([] if extra is None else [run_dir] + extra) + ["--device", device]
            rc, out, launches, _trace, secs = run_script(name, argv, waves)
            if rc != 0:
                raise AssertionError(f"scripts golden: {label} returned {rc}")
            hashes = stage_hashes(run_dir)
            bad = [st for st in rewrites if hashes[st] != pinned[st]]
            if bad:
                raise AssertionError(f"scripts golden: {label}: stage hashes differ: {bad}")
            if device == "cuda" and dp and not (launches["banded_fwd"] + launches[
                    "banded_fwd_waves"] and launches["banded_tb"]):
                raise AssertionError(f"scripts golden: {label} launched {launches}")
            if (launches["banded_fwd_waves"] > 0) != bool(waves):
                raise AssertionError(f"scripts golden: {label} launched {launches}")
            runs.setdefault(device, []).append({
                "script": name, "waves": waves, "stdout": out.replace(run_dir, "<run>"),
                "launches": launches, "seconds": secs,
            })
            log(f"  [scripts golden] {label}: {secs:.2f}s, launches {launches}, "
                f"{out.strip().splitlines()[0] if out.strip() else ''}")
        runs[device + "-files"] = {}
        for name in OUTPUTS:
            with open(os.path.join(run_dir, name), "rb") as f:
                runs[device + "-files"][name] = f.read()
    cuda = [r for r in runs["cuda"] if not r["waves"]]
    if [r["stdout"] for r in cuda] != [r["stdout"] for r in runs["cpu"]]:
        raise AssertionError("scripts golden: the card's output differs from the CPU's")
    if runs["cuda"][1]["stdout"] != runs["cpu"][0]["stdout"]:
        raise AssertionError("scripts golden: ComputeAlignments under waves 2 printed otherwise")
    phase3 = {}
    for name in OUTPUTS:
        with open(os.path.join(src, name), "rb") as f:
            phase3[name] = f.read()
    if not runs["cuda-files"] == runs["cpu-files"] == phase3:
        raise AssertionError("scripts golden: Mode0Assembly.py's FASTA/GFA differ from phase 3's")

    # The driver as a user runs it: a file in a shell, on the card by default.
    run_dir = os.path.join(work, "scripts-golden-cuda")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "FlagPalindromicReads.py"), run_dir],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"FlagPalindromicReads.py in a shell: {r.stderr[-2000:]}")
    if r.stdout != runs["cuda"][2]["stdout"] or stage_hashes(run_dir)["Reads"] != pinned["Reads"]:
        raise AssertionError(f"FlagPalindromicReads.py in a shell printed {r.stdout!r}")
    log(f"  [scripts golden] python3 shasta_tpu_torch/scripts/FlagPalindromicReads.py: "
        f"{secs:.2f}s, {r.stdout.strip()}")
    launches = {k: sum(x["launches"][k] for x in runs["cuda"]) for k in runs["cuda"][0]["launches"]}
    log(
        "scripts golden: the re-run stages' hashes equal the pinned values on the card "
        "and the CPU; the card's output equals the CPU's; Mode0Assembly.py's FASTA and "
        f"GFA byte-equal to phase 3's; card launches {launches}"
    )
    return {"launches": launches, "cuda": runs["cuda"], "cpu": runs["cpu"],
            "shell_s": secs}


def phase_scripts_real_size(real, sm_clock_mhz):
    """Phase 11b: ComputeAlignments.py and FlagPalindromicReads.py on the
    card on phase 4's 5 Mb run directory (Nanopore-May2022 verbatim, as
    its shasta.conf holds it)."""
    run_dir = real["dir"]
    out = {}
    total = {"banded_fwd": 0, "banded_tb": 0, "banded_fwd_waves": 0}
    for name, stage in (("ComputeAlignments", "Alignments"), ("FlagPalindromicReads", "Reads")):
        rc, text, launches, trace, secs = run_script(name, [run_dir])
        if rc != 0:
            raise AssertionError(f"scripts 5 Mb: {name}.py returned {rc}")
        h = stage_hashes(run_dir)[stage]
        if h != real["hashes"][stage]:
            raise AssertionError(f"scripts 5 Mb: {name}.py's {stage} hash differs from phase 4's")
        # The palindrome pass's host prefilter clears every read of this
        # sample, as in phase 4's run, so only computeAlignments launches.
        if name == "ComputeAlignments" and not (launches["banded_fwd"] and launches["banded_tb"]):
            raise AssertionError(f"scripts 5 Mb: {name}.py launched {launches}")
        shapes = kernel_classes(trace, sm_clock_mhz, f"scripts 5 Mb {name}")
        ms = sum(c["device_ms"] for c in shapes)
        log(f"scripts 5 Mb: {name}.py {secs:.2f}s wall, kernels {ms:.1f} ms, launches "
            f"{launches}, {stage} hash equal to phase 4's; {text.strip()}")
        for k in total:
            total[k] += launches[k]
        out[name] = {"seconds": secs, "launches": launches, "shapes": shapes,
                     "kernel_ms": ms, "stdout": text}
    if not any(c["LA"] >= 8192 for c in out["ComputeAlignments"]["shapes"]):
        raise AssertionError("scripts 5 Mb: ComputeAlignments.py launched no class at LA >= 8192")
    out["launches"] = total
    return out


# ---------------------------------------------------------------------------
# Phase 12: the bench entry point
# ---------------------------------------------------------------------------

# bench.py's JSON line, in its order (bench.py:303-320).
BENCH_KEYS = [
    "metric", "value", "unit", "vs_baseline", "mesh1_alignments_per_sec",
    "mesh1_host_ratio", "kernel_gcells_per_sec", "kernel_chunked_gcells_per_sec",
    "kernel_pairs_per_sec", "kernel_ops_per_cell", "vpu_peak_gops", "kernel_pct_peak",
]
# The bench's timed reps here (its default is bench.py's 12).
BENCH_REPS = 3


def phase_bench(sm_clock_mhz):
    """Phase 12: ``python -m shasta_tpu_torch.bench --reps 3`` at bench.py's
    workload as a process of its own (its one-rank NCCL world lives
    there), its last stdout line held to bench.py's 12 keys, finite
    values, value and the Gcells rates above 0 and kernel_pct_peak at 105
    or below; its launches (stderr) are the "bench" path. Then, in this
    process: every kernel of the roofline batch (B 1024 x LA 512 x W 128)
    equal to the plain version bit for bit (check_kernels: banded_fwd's
    bodies, banded_tb, banded_align_pairs and banded_fwd_waves at waves 2
    and 4, the shape waves_ab times in phase 13); int32_chain against its plain version
    (check_int32_chain); two reps of the bench's align_candidates and a
    rep under a one-rank mesh giving equal AlignmentStores; 128 of the
    kept pairs re-aligned with the plain version (spot_check)."""
    import torch.distributed as dist

    from shasta_tpu_torch import bench as PB
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.ops.align import AlignParams
    from shasta_tpu_torch.parallel.context import use_mesh
    from shasta_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "shasta_tpu_torch.bench", "--reps", str(BENCH_REPS)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    bench_s = time.perf_counter() - t0
    for ln in proc.stderr.splitlines():
        if ln.startswith("bench: "):
            log(ln)
    if proc.returncode != 0:
        raise AssertionError(f"the bench exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    last = proc.stdout.strip().splitlines()[-1]
    line = json.loads(last)
    if list(line) != BENCH_KEYS:
        raise AssertionError(f"the bench's line has keys {list(line)}")
    nums = [v for k, v in line.items() if k not in ("metric", "unit")]
    if not all(isinstance(v, (int, float)) and np.isfinite(v) for v in nums):
        raise AssertionError(f"the bench's line has a value that is not finite: {last}")
    if min(line["value"], line["kernel_gcells_per_sec"],
           line["kernel_chunked_gcells_per_sec"]) <= 0 or line["kernel_pct_peak"] > 105:
        raise AssertionError(f"the bench's line is out of range: {last}")
    launches = json.loads(re.search(r"^bench: launches (\{.*\})$", proc.stderr, re.M).group(1))
    if not (launches["banded_fwd"] and launches["banded_tb"] and launches["int32_chain"]):
        raise AssertionError(f"the bench did not launch every kernel of its path: {launches}")
    log(f"bench: {bench_s:.1f}s, exit 0, line {last}")

    dev = torch.device("cuda")
    host = PB.roofline_batch()
    (a, *_), *_ = check_kernels(host, host[0].shape[1], PB.ROOFLINE_W)
    log(f"bench: the roofline batch ({a.shape[0]} pairs, LA {a.shape[1]}, W "
        f"{PB.ROOFLINE_W}): every kernel equal to the plain version (banded_fwd_waves at "
        f"waves {', '.join(map(str, WAVES))})")
    chain = check_int32_chain(sm_clock_mhz)

    t0 = time.perf_counter()
    markers, kt, cand = PB.build_workload()
    run = PB.workload_runner(markers, kt, cand, dev)
    first, second = run(), run()
    created = not dist.is_initialized()
    try:
        with use_mesh(make_mesh(1, device=dev)):
            on_mesh = run()
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
    ref = first.arrays()
    for name, other in (("a second rep", second), ("the one-rank mesh", on_mesh)):
        got = other.arrays()
        if sorted(got) != sorted(ref) or not all(np.array_equal(got[k], v) for k, v in ref.items()):
            raise AssertionError(f"bench: {name}'s AlignmentStore differs from the first rep's")
    log(f"bench: {cand.count} candidates, {first.count} kept; two reps and a one-rank NCCL "
        f"mesh rep give equal AlignmentStores ({time.perf_counter() - t0:.1f}s)")
    spot_check("bench", markers, kt, first, AlignParams(**PB.ALIGN))
    return {"line": line, "launches": launches, "seconds": bench_s, "int32_chain": chain}


def check_int32_chain(sm_clock_mhz):
    """int32_chain against int32_chain_plain on the card, modulo 2**32: at
    K 256 on the bench's tile (where the chain reaches a fixed point within
    5 iterations) and at K 1, 2 and 5 on 1,000,003 values over the whole
    int32 range (a ragged last block). Times both at K 256 on the bench's
    tile, against bound_ms."""
    from shasta_tpu_torch import bench as PB
    from shasta_tpu_torch.utils import peak

    tile = torch.from_numpy(PB.ceiling_tile()).cuda()
    full = torch.from_numpy(
        np.random.default_rng(24).integers(-(2**31), 2**31, 1_000_003).astype(np.int32)
    ).cuda()
    errs = {}
    for name, x, K in (("tile", tile, 256), ("full", full, 1), ("full", full, 2),
                       ("full", full, 5)):
        d = peak.int32_chain(x, K).long() - peak.int32_chain_plain(x, K).long()
        errs[f"{name} K {K}"] = int(((d + 2**31) % 2**32 - 2**31).abs().max())
    if any(errs.values()):
        raise AssertionError(f"int32_chain != plain (modulo 2**32): {errs}")
    K = 256
    ms = cuda_ms(lambda: peak.int32_chain(tile, K), 20)
    plain_ms = cuda_ms(lambda: peak.int32_chain_plain(tile, K), 1)
    bound, by, _, _ = bound_ms(
        tile.numel() * peak.OPS_PER_ITERATION * K, 8 * tile.numel(), sm_clock_mhz
    )
    log(f"int32_chain: equal to the plain version modulo 2**32 ({', '.join(errs)}); at K {K} "
        f"on the bench's (1024, 512) tile {ms:.4f} ms (plain {plain_ms:.1f} ms; bound "
        f"{bound:.4f} ms by {by}, {bound / ms:.1%})")
    check_shares("int32_chain", bound, {"int32_chain": ms})
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "max_abs_err": max(errs.values()), "K": K, "tile": list(tile.shape)}


# ---------------------------------------------------------------------------
# Phase 13 and the scale runs
# ---------------------------------------------------------------------------


class _Tee(io.TextIOBase):
    """A text stream that keeps what is written and passes it on to
    ``echo`` (None: keeps it only)."""

    def __init__(self, echo):
        self.echo, self.parts = echo, []

    def write(self, s):
        self.parts.append(s)
        if self.echo is not None:
            self.echo.write(s)
        return len(s)

    def flush(self):
        if self.echo is not None:
            self.echo.flush()


def printed_json(text):
    """Every JSON object the module printed, in order: at a line that
    starts with "{" or with "stage seconds: {" (that one under the key
    "stageSeconds")."""
    dec = json.JSONDecoder()
    found = []
    for m in re.finditer(r"^(stage seconds: )?\{", text, re.M):
        try:
            obj, _ = dec.raw_decode(text, m.end() - 1)
        except json.JSONDecodeError:
            continue
        found.append({"stageSeconds": obj} if m.group(1) else obj)
    return found


def run_module(name, sm_clock_mhz, argv=(), env=None, tmp=None, constants=None, echo=False):
    """``shasta_tpu_torch.benchmarks.<name>.main(argv)`` in this process,
    with ``env`` set and the module's ``constants`` replaced for the
    duration, ``tempfile.mkdtemp`` inside ``tmp``: launch counts reset
    just before and read just after, the launch trace on, the device's
    peak memory reset. Returns its exit code, wall seconds, launches,
    kernel classes (kernel_classes) and their device ms, largest LA, the
    class-matrix caches' builds (every _DeviceCsr the run made), peak
    device memory (allocated and reserved) and this process's peak RSS,
    the JSON objects it printed, and the sha256 of each FASTA of each run
    directory it left in ``tmp``."""
    import importlib
    import resource

    from shasta_tpu_torch.ops import align as AL
    from shasta_tpu_torch.ops import align_kernel as K

    mod = importlib.import_module(f"shasta_tpu_torch.benchmarks.{name}")
    env = dict(env or {})
    constants = dict(constants or {})
    old_env = {k: os.environ.get(k) for k in env}
    old_consts = {k: getattr(mod, k) for k in constants}
    old_tmp, init = tempfile.tempdir, AL._DeviceCsr.__init__
    csrs = []

    def counted_init(self, *a, **kw):
        init(self, *a, **kw)
        csrs.append(self)

    out = _Tee(sys.stdout if echo else None)
    os.environ.update(env)
    for k, v in constants.items():
        setattr(mod, k, v)
    tempfile.tempdir = tmp
    AL._DeviceCsr.__init__ = counted_init
    reset_launches()
    K.TRACE = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with waves_env(None), contextlib.redirect_stdout(out):
            rc = mod.main(list(argv))
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        AL._DeviceCsr.__init__ = init
        tempfile.tempdir = old_tmp
        for k, v in old_consts.items():
            setattr(mod, k, v)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        trace, K.TRACE = K.TRACE, None
    launches = dict(K.LAUNCHES)
    shapes = kernel_classes(trace, sm_clock_mhz, name, echo=False)
    fastas = {}
    for d in sorted(os.listdir(tmp)) if tmp else []:
        for sub in sorted(os.listdir(os.path.join(tmp, d))):
            p = os.path.join(tmp, d, sub)
            for f in sorted(os.listdir(p)) if os.path.isdir(p) else [""]:
                fp = os.path.join(p, f) if f else p
                if fp.endswith(".fasta"):
                    fastas[os.path.relpath(fp, os.path.join(tmp, d))] = {
                        "bytes": os.path.getsize(fp), "sha256": file_sha256(fp)}
    return {
        "module": name, "argv": list(argv), "env": env, "constants": constants, "rc": rc,
        "wall_s": wall, "launches": launches, "shapes": shapes,
        "device_ms": {k: sum(c["device_ms"] for c in shapes if c["kernel"] == k)
                      for k in launches},
        "max_LA": max((c["LA"] for c in shapes), default=0),
        "csr_builds": [{"builds": c.builds, "classes": sorted(c._members),
                        "budget_mb": c._mat_budget >> 20} for c in csrs],
        "peak_device_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_device_reserved_bytes": torch.cuda.max_memory_reserved(),
        "peak_rss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
        "printed": printed_json("".join(out.parts)), "fastas": fastas,
    }


# Phase 13's runs: (label, module, environment, constants). mode2_phase_exp
# runs two of its four configurations (PHASE_EXP_CONFIGS), the default
# thresholds and both raised, to keep the phase near 120 s; the CPU tests
# hold all four to the JAX script's.
PHASE_EXP_CONFIGS = ("ref_defaults", "both")
BENCHMARK_RUNS = [
    ("scale-uniform1-1mb", "scale_bench", {"SCALE": "1", "REGIME": "uniform1"}, None),
    ("mode2-uniform1-1mb", "mode2_scale_bench", {"SCALE": "1", "REGIME": "uniform1"}, None),
    ("waves-ab", "waves_ab", {"WAVES_AB_REPS": "2"}, None),
    ("scale-ont-1mb", "scale_bench", {"SCALE": "1", "REGIME": "ont"}, None),
    ("phase-exp-500kb", "mode2_phase_exp", {}, {"SIZE": 500_000, "CONFIGS": PHASE_EXP_CONFIGS}),
]


def phase_benchmarks(real, sm_clock_mhz):
    """Phase 13: the scale and A/B modules (shasta_tpu_torch/benchmarks), each
    through its main(["--device", "cuda"]) in this process (run_module:
    launch counts from 0 just before each run), at cut sizes
    (BENCHMARK_RUNS). Each assembly run must launch banded_fwd and
    banded_tb and not banded_fwd_waves, print its graded summary (or one
    line a configuration) and leave non-empty FASTA files; waves_ab must
    launch all three kernels (it raises unless every variant's chain
    equals waves 1's) and print its JSON line. Then scale_bench's reads at
    SCALE=5 REGIME=ont must hash equal to phase 4's FASTA."""
    from shasta_tpu_torch.benchmarks import mode2_phase_exp as PE
    from shasta_tpu_torch.benchmarks import scale_bench as SB
    from shasta_tpu_torch.utils import synth

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_13_") as work:
        for label, name, env, constants in BENCHMARK_RUNS:
            tmp = os.path.join(work, label)
            os.makedirs(tmp)
            if constants and "CONFIGS" in constants:
                constants = {**constants, "CONFIGS": [
                    c for c in PE.CONFIGS if c[0] in constants["CONFIGS"]]}
            r = run_module(name, sm_clock_mhz, ["--device", "cuda"], env, tmp, constants)
            n = r["launches"]
            if r["rc"] != 0:
                raise AssertionError(f"{label}: main returned {r['rc']}")
            want_waves = name == "waves_ab"
            if not (n["banded_fwd"] and n["banded_tb"]) or (
                    bool(n["banded_fwd_waves"]) != want_waves):
                raise AssertionError(f"{label}: launches {n}")
            if want_waves:
                line = r["printed"][-1]
                if sorted(line) != sorted(
                        ["waves1_gcells_per_sec", "waves2_gcells_per_sec",
                         "waves4_gcells_per_sec", "speedup_w2", "speedup_w4"]) or min(
                        line.values()) <= 0:
                    raise AssertionError(f"{label}: its line {line}")
                graded = line
            else:
                empty = [f for f, e in r["fastas"].items() if e["bytes"] == 0]
                if not r["fastas"] or empty:
                    raise AssertionError(f"{label}: no FASTA or an empty one: {r['fastas']}")
                if name == "mode2_phase_exp":
                    graded = [o for o in r["printed"] if "config" in o]
                    if [o["config"] for o in graded] != list(PHASE_EXP_CONFIGS):
                        raise AssertionError(f"{label}: its lines {graded}")
                else:
                    graded = next(o for o in r["printed"] if "regime" in o)
                    if not graded["accuracy"]["contigKmers"]:
                        raise AssertionError(f"{label}: nothing graded: {graded['accuracy']}")
            stages = next((o["stageSeconds"] for o in r["printed"] if "stageSeconds" in o
                           and len(o) == 1), {})
            log(
                f"{label} ({name}, {env}, {constants or ''}): {r['wall_s']:.1f}s, launches "
                f"{n}, kernels {r['device_ms']} ms, largest LA {r['max_LA']}, class-matrix "
                f"builds {[c['builds'] for c in r['csr_builds']]}, peak device memory "
                f"{r['peak_device_allocated_bytes'] / 2**30:.2f} GiB; stage seconds "
                f"{stages}; graded {graded}"
            )
            runs[label] = r

        t0 = time.perf_counter()
        fasta = os.path.join(work, "scale5-ont.fasta")
        genome = SB.make_genome(5)
        synth.write_fasta(fasta, SB.make_reads(genome, "ont", 5))
        got = file_sha256(fasta)
    if got != real["fasta_sha256"]:
        raise AssertionError(f"scale_bench's SCALE=5 ont reads {got[:12]} differ from "
                             f"phase 4's {real['fasta_sha256'][:12]}")
    log(f"scale_bench's reads at SCALE=5 REGIME=ont hash equal to phase 4's FASTA "
        f"({got[:16]}; {time.perf_counter() - t0:.1f}s)")
    return {"runs": runs, "scale5_ont_fasta_sha256": got}


def record_module(argv) -> int:
    """``python3 chip_smoke.py --module NAME [--out FILE]``:
    one run of a benchmarks module on the card (run_module, its output
    echoed, kernels built before), the environment's SCALE, REGIME,
    ITERATIVE and WAVES_AB_REPS as given; writes the record to
    chiprun_out/FILE (default module-NAME.json) and prints the card, the
    host's memory and a one-line digest."""
    import argparse

    p = argparse.ArgumentParser(prog="python3 chip_smoke.py --module")
    p.add_argument("--module", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from shasta_tpu_torch.ops import align_kernel as K
    from shasta_tpu_torch.utils import peak

    card = peak.nvidia_smi("name,power.limit")
    sm_clock = float(peak.nvidia_smi("clocks.max.sm").split()[0])
    build_s = K.build_kernels()
    page = os.sysconf("SC_PAGE_SIZE")
    env = {k: os.environ[k] for k in ("SCALE", "REGIME", "ITERATIVE", "WAVES_AB_REPS")
           if k in os.environ}
    log(f"record: {args.module} on {card}; kernels built in {build_s:.2f}s; host memory "
        f"{os.sysconf('SC_PHYS_PAGES') * page / 2**30:.1f} GiB, free "
        f"{os.sysconf('SC_AVPHYS_PAGES') * page / 2**30:.1f} GiB; env {json.dumps(env)}")
    with tempfile.TemporaryDirectory(prefix="record_") as tmp:
        r = run_module(args.module, sm_clock, ["--device", "cuda"], env, tmp, echo=True)
    r["card"], r["sm_clock_mhz"], r["build_s"] = card, sm_clock, build_s
    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, args.out or f"module-{args.module}.json")
    with open(out, "w") as f:
        json.dump(r, f, indent=1)
    classes = [(c["kernel"], c["body"], c["LA"], c["W"], c["launches"], round(c["device_ms"], 2))
               for c in r["shapes"]]
    log(f"record: rc {r['rc']}, wall {r['wall_s']:.1f}s, launches {r['launches']}, device ms "
        f"{r['device_ms']}, largest LA {r['max_LA']}, classes {classes}, class-matrix builds "
        f"{r['csr_builds']}, peak device memory allocated "
        f"{r['peak_device_allocated_bytes'] / 2**30:.2f} GiB, reserved "
        f"{r['peak_device_reserved_bytes'] / 2**30:.2f} GiB, peak RSS "
        f"{r['peak_rss_kb'] / 2**20:.2f} GiB; FASTA {r['fastas']}; written to {out}")
    return r["rc"]


# ---------------------------------------------------------------------------


def main() -> int:
    t_start = time.perf_counter()
    seconds = {}
    out = {}

    def run(n, fn, *a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        seconds[n] = seconds.get(n, 0.0) + time.perf_counter() - t0
        log(f"phase {n}: {seconds[n]:.1f}s")
        return r

    sm_clock, build = run(1, phase_device_and_build)
    spot_checks_start()
    try:
        kernels = run(2, phase_kernels, sm_clock)
        out["kmer_table"] = run(2, phase_kmer_table, sm_clock)
        blocks = run(2, phase_blocks_per_sm)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            run(3, phase_golden, work)
            out["palindrome_wide"] = run(3, phase_palindrome_wide, work, sm_clock)
            real = run(4, phase_real_size, work, sm_clock)
            out["mode2_golden"] = run(5, phase_mode2_golden, work)
            out["mode2_real_size"] = run(6, phase_mode2_real_size, work, sm_clock)
            run(7, phase_method4_golden, work)
            out["method4_real_size"] = run(
                7, phase_method4_real_size, real["dir"], sm_clock
            )
            run(7, phase_iterative, work)
            out["mode3_test_inputs"] = run(8, phase_mode3_test_inputs, work)
            out["mode3_real_size"] = run(8, phase_mode3_real_size, work, sm_clock)
            out["mesh"] = run(9, phase_mesh, work, real, sm_clock)
            out["explorer"] = run(10, phase_explorer, work)
            spot_checks_finish()
            # Phase 11 rewrites stages of the runs the spot checks read.
            out["scripts_golden"] = run(11, phase_scripts_golden, work)
            out["scripts_5mb"] = run(11, phase_scripts_real_size, real, sm_clock)
        out["bench"] = run(12, phase_bench, sm_clock)
        out["benchmarks"] = run(13, phase_benchmarks, real, sm_clock)
    finally:
        spot_checks_stop()
    log("phase seconds: " + ", ".join(f"{n} {t:.1f}" for n, t in sorted(seconds.items())))
    from shasta_tpu_torch.utils.peak import nvidia_smi

    card = nvidia_smi("name,power.limit")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(
            {"card": card, "sm_clock_mhz": sm_clock, "build": build,
             "kernels": [dict(v) for v in kernels.values()],
             "blocks_per_sm": blocks, "real_size": real, **out,
             "phase_seconds": seconds, "seconds": time.perf_counter() - t_start},
            f, indent=1,
        )
    log(f"total {time.perf_counter() - t_start:.1f}s")
    line = kernel_line(kernels, real, out)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def kernel_line(kernels, real, out):
    """The {"kernels": [...]} line. Each kernel's launches are summed over
    the paths that ran it, each counted from 0 just before its run: the
    mode-0 real-size run (phase 4), its computeAlignments rerun under
    waves 2, the mode-2 real-size run (phase 6), the mode-2 golden run
    under waves 2 (phase 5), method 4 at a real size (phase 7), the
    mode-3 real-size run (phase 8), the mesh's runs (phase 9: the
    one-rank NCCL checks, and the sum over the two gloo ranks of the
    golden and 5 Mb runs), the explorer's pages (phase 10), the stage
    drivers (phase 11: the card's runs on the golden run, and the 5 Mb
    run's), the bench (phase 12, its own process's counts) and the
    benchmarks modules' runs (phase 13).
    banded_fwd's entry is its row-scan body's (csrc/banded_align.cu):
    phase 2's times at the shape of the row-scan body's class that took
    the most of its time on the mode-0 run (a phase-1-like batch where
    phase 2 has one), with the anti-diagonal body's beside them at the
    shape whose class took the most banded_fwd time, where banded_tb's
    times are taken too."""
    paths = {
        "mode0": real["launches"],
        "mode0-waves2": real["reruns"]["waves2"]["launches"],
        "mode2": out["mode2_real_size"]["launches"],
        "mode2-waves2": out["mode2_golden"]["mode2-golden-cuda-waves2"]["launches"],
        "method4": out["method4_real_size"]["launches"],
        "mode3": out["mode3_real_size"]["launches"],
        "mesh-1rank-nccl": out["mesh"]["a"]["launches"],
        "mesh-2ranks-golden": out["mesh"]["b"]["launches"],
        "mesh-2ranks-5mb": out["mesh"]["c"]["launches"],
        "explorer": {k: sum(e["launches"][k] for e in out["explorer"].values())
                     for k in out["explorer"]["golden"]["launches"]},
        "scripts-golden": out["scripts_golden"]["launches"],
        "scripts-5mb": out["scripts_5mb"]["launches"],
        "bench": out["bench"]["launches"],
        **{f"benchmarks-{label}": r["launches"]
           for label, r in out["benchmarks"]["runs"].items()},
    }

    def launched(name):
        ran = [p for p, launches in paths.items() if launches.get(name)]
        return {"launches": sum(paths[p][name] for p in ran), "paths": ran}

    def by_body(shapes):
        n = {"rows": 0, "diag": 0}
        for c in shapes:
            if c["kernel"] == "banded_fwd":
                n[c["body"]] += c["launches"]
        return n

    # banded_fwd's launches on each body, on the paths that keep a trace.
    bodies = {p: by_body(shapes) for p, shapes in {
        "palindrome": out["palindrome_wide"]["cuda"]["shapes"],
        "mode0": real["shapes"],
        "mode0-waves2": real["reruns"]["waves2"]["shapes"],
        "mode2": out["mode2_real_size"]["shapes"],
        "method4": out["method4_real_size"]["shapes"],
        "mode3": out["mode3_real_size"]["shapes"],
        "mesh-2ranks-5mb": [c for r in out["mesh"]["c"]["ranks"] for c in r["shapes"]],
        "scripts-5mb": [c for n in ("ComputeAlignments", "FlagPalindromicReads")
                        for c in out["scripts_5mb"][n]["shapes"]],
    }.items()}
    fwd_ms, rows_ms = {}, {}
    for c in real["shapes"]:
        if c["kernel"] == "banded_fwd":
            key = (c["LA"], c["W"])
            fwd_ms[key] = fwd_ms.get(key, 0.0) + c["device_ms"]
            if c["body"] == "rows":
                rows_ms[key] = rows_ms.get(key, 0.0) + c["device_ms"]
    rep = max(
        (k for k in kernels if k[2] == "make"),
        key=lambda k: (fwd_ms.get(k[:2], 0.0), k[0] * k[1]),
    )
    r = kernels[rep]
    shape = {"LA": rep[0], "W": rep[1], "B": r["B"]}
    rep_rows = max(
        (k for k, v in kernels.items() if v["body"] == "rows"),
        key=lambda k: (rows_ms.get(k[:2], 0.0), k[2] == "full", k[0] * k[1]),
    )
    rr = kernels[rep_rows]
    # banded_fwd_waves at the listed shape, among those it takes, whose
    # class took the most forward time in the waves-2 rerun.
    waves_fwd = {
        (c["LA"], c["W"]): c["device_ms"]
        for c in real["reruns"]["waves2"]["shapes"] if c["kernel"] == "banded_fwd_waves"
    }
    rep_w = max(
        (k for k, v in kernels.items() if v["waves_ms"]),
        key=lambda k: (waves_fwd.get(k[:2], 0.0), k[0] * k[1]),
    )
    rw = kernels[rep_w]
    ic = out["bench"]["int32_chain"]
    kt = out["kmer_table"]
    csrc = "shasta_tpu_torch/csrc/"
    return {"kernels": [
        {"name": "banded_fwd", "route": "cuda", "source": csrc + "banded_align.cu",
         "replaces": "shasta_tpu/ops/align_pallas.py:156,581",
         **launched("banded_fwd"),
         "max_abs_err": max(k["max_abs_err"] for k in kernels.values()),
         "ms": rr["rows_ms"], "plain_ms": rr["fwd_plain_ms"],
         "bound_ms": rr["fwd_bound_ms"], "bound_by": rr["fwd_bound_by"],
         "library_ms": None,
         "shape": {"LA": rep_rows[0], "W": rep_rows[1], "B": rr["B"],
                   "batch": rep_rows[2], "body": "rows", "rows_plan": rr["rows_plan"]},
         "launches_by_body": bodies,
         "anti_diagonal": {
             "source": csrc + "banded_fwd_diag.cu", "ms": r["diag_ms"],
             "plain_ms": r["fwd_plain_ms"], "bound_ms": r["fwd_bound_ms"],
             "bound_by": r["fwd_bound_by"], "shape": dict(shape, body=r["body"])}},
        {"name": "banded_tb", "route": "cuda", "source": csrc + "banded_tb.cu",
         "replaces": "shasta_tpu/ops/align_pallas.py:296,714",
         **launched("banded_tb"), "max_abs_err": r["max_abs_err"],
         "ms": r["tb_ms"], "plain_ms": r["tb_plain_ms"],
         "bound_ms": r["tb_bound_ms"], "bound_by": r["tb_bound_by"],
         "library_ms": None, "shape": shape},
        {"name": "banded_fwd_waves", "route": "cuda",
         "source": csrc + "banded_fwd_diag.cu",
         "replaces": "shasta_tpu/ops/align_pallas.py:340",
         **launched("banded_fwd_waves"),
         "max_abs_err": max(k["waves_max_abs_err"] for k in kernels.values()),
         "ms": rw["waves_ms"][2], "plain_ms": rw["fwd_plain_ms"],
         "bound_ms": rw["fwd_bound_ms"], "bound_by": rw["fwd_bound_by"],
         "library_ms": None,
         "shape": {"LA": rep_w[0], "W": rep_w[1], "B": rw["B"], "waves": 2},
         "waves4_ms": rw["waves_ms"][4], "banded_fwd_ms": rw["fwd_ms"]},
        {"name": "int32_chain", "route": "cuda", "source": csrc + "int32_peak.cu",
         "replaces": "bench.py:143 (vpu_peak_prepare, an XLA-fused jnp chain; no Pallas)",
         **launched("int32_chain"), "max_abs_err": ic["max_abs_err"],
         "ms": ic["ms"], "plain_ms": ic["plain_ms"], "bound_ms": ic["bound_ms"],
         "bound_by": ic["bound_by"], "library_ms": None,
         "shape": {"tile": ic["tile"], "K": ic["K"]}},
        {"name": "kmer_table", "route": "cuda", "source": csrc + "kmer_table.cu",
         "replaces": "shasta_tpu/data/kmers.py:downsampling_hash_table (numpy on the host; no Pallas)",
         "launches": real["kmer_table_launches"], "paths": ["mode0"], "max_abs_err": 0,
         "ms": kt["ms"], "plain_ms": kt["plain_ms"], "bound_ms": kt["bound_ms"],
         "bound_by": kt["bound_by"], "library_ms": None,
         "shape": {"k": kt["k"], "ids": kt["ids"]}},
    ]}


if __name__ == "__main__":
    sys.exit(record_module(sys.argv[1:]) if sys.argv[1:] else main())
