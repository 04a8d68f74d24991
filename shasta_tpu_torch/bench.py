"""Benchmark: marker alignments per second on one card.

Counterpart of the repository root's ``bench.py`` for the PyTorch/CUDA
port:

    python -m shasta_tpu_torch.bench [--device cuda|cpu] [--reps N]

``--device`` is ``cuda`` unless the caller asks for the CPU (the kernels'
plain PyTorch version; no number it prints is a card's); without a card
``cuda`` raises. ``--reps`` (default 12, as bench.py) is the number of
timed ``align_candidates`` reps of each kind; it sizes nothing.

The workload and the formulas are bench.py's:

- ``build_workload``: a random genome of 800 kb (seed 5), 4000 reads of
  3000 bases from both strands, k-mers by ``select_kmers_random(8, 0.1,
  seed=231)``, markers, LowHash candidates (m 4, fraction 0.05, 6
  iterations, min frequency 2, bucket size 60): about 60k pairs of
  sequences of a few hundred markers.
- ``value``: the best over the reps of candidates / seconds of
  ``align_candidates`` (method 3, ``AlignParams(20, 60, 60, 60)``), the
  downsampling table built before; ``vs_baseline`` = value / 7400, the
  reference's rate on 128 cores (bench.py's docstring). The warm-up
  call pays for the kernel build and every first use. The same reps run
  under a one-device mesh (``make_mesh(1)``: a one-rank NCCL world on
  the card, gloo on the CPU, destroyed at the end), interleaved with the
  host reps: ``mesh1_alignments_per_sec`` and ``mesh1_host_ratio``.
- ``kernel_gcells_per_sec`` and ``kernel_pairs_per_sec``: the marginal
  throughput of ``banded_align_pairs`` (forward, ``banded_tb`` and
  ``metrics_from_mj``) on a seeded batch of 1024 pairs at LA = LB = 512,
  W 128: K calls, each on ``b`` rolled by the call's index, their
  outputs summed on the device, timed at K 26 against K 2; B LA W cells
  and B pairs over the time of one call. On the card each chain is
  captured once in a CUDA graph and timed by its replays (CUDA events),
  so the time is the card's alone, as bench.py's single jitted loop is:
  a call from Python also pays the host's enqueue of the wrapper's
  torch ops, which the K 26 - K 2 difference does not cancel (it grows
  with K). stderr gives the rate of both. The launch counts count
  each captured launch once and no replay.
- ``kernel_chunked_gcells_per_sec``: the JAX package's other route
  (``_fwd_chunked_kernel`` + ``_tb_chunked_kernel``) at the same shape.
  The port has one route for both TPU routes (``banded_fwd`` and
  ``banded_tb`` always pass the dirs through device memory), so this is
  a separate rep of the same launch at the same shape.
- ``vpu_peak_gops``: the card's int32 elementwise ceiling, bench.py's
  eight-operation chain over a seeded (1024, 512) tile, timed at K 8448
  against K 256, as the hand-written kernel ``csrc/int32_peak.cu``
  (``utils/peak.py:int32_chain``); operations counted by the chain's
  eight source operations, as bench.py counts them. This tile does not
  split evenly over an H100's SMs (31.03 warps a sub-partition on
  average, 32 on the slowest), so it is this tile's ceiling, which may
  differ by a few per cent from the one ``chip_smoke.py`` phase 1
  measures on a tile every SM shares equally; the bounds there divide
  by neither, but by the issue limit (``peak.issue_limit_ops``).
- ``kernel_ops_per_cell``: ``align_kernel.FWD_INT_OPS_PER_CELL`` (13), the
  int32 operations a cell needs, which the port's bounds count; the
  TPU kernel's 62 counted what that kernel executes, and a count of
  instructions issued would reward a kernel that wastes them. So
  ``kernel_pct_peak`` = 100 gcells 13 / vpu_peak_gops is the share of
  the bound under this tile's ceiling.

Where bench.py turns a failure into a 0 (a mesh that does not start, a
rep that raises or times nothing), the port raises: the process exits
non-zero and prints no result. The 900 s cap on the timed reps stays.

The last line of stdout is one JSON object with bench.py's 12 keys in
its order. Everything else goes to stderr: the card's name and power
limit, its SM clock, the data sheet's int32 rate and the issue limit,
the launches of each kernel, the card's busy share (the DP kernels'
device time over the wall time) during one ``align_candidates``, and
the roofline's time a call from graph replays and from Python.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from shasta_tpu_torch.ops import align_kernel as AK
from shasta_tpu_torch.utils import peak

REFERENCE_ALIGNMENTS_PER_SEC = 7400.0
SCORES = dict(match=6, mismatch=-1, gap=-1)
# The time guard of the timed reps (bench.py:254).
TIMED_REPS_CAP_S = 900.0
# Interleaved reps of the roofline and the ceiling (bench.py:274).
KERNEL_REPS = 4
# The roofline batch's band width (bench.py:86).
ROOFLINE_W = 128
# bench.py's AlignParams (bench.py:207).
ALIGN = dict(min_aligned_marker_count=20, max_skip=60, max_drift=60, max_trim=60)


def say(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def build_workload(n_reads=4000, read_len=3000, genome_size=800000, seed=5):
    """bench.py:build_workload through the port: (markers, k-mer table,
    candidates)."""
    from shasta_tpu_torch.data import bases as B
    from shasta_tpu_torch.data.kmers import select_kmers_random
    from shasta_tpu_torch.data.markers import find_markers
    from shasta_tpu_torch.data.reads import build_read_store
    from shasta_tpu_torch.io.fasta import parse_fasta_bytes
    from shasta_tpu_torch.ops import lowhash as LH
    from shasta_tpu_torch.utils import synth

    genome = synth.random_genome(genome_size, seed=seed)
    reads = synth.sample_reads(genome, n_reads, read_len, seed=seed + 1, both_strands=True)
    fasta = b"".join(
        b">r%d\n%s\n" % (i, B.decode_to_str(r).encode()) for i, r in enumerate(reads)
    )
    store = build_read_store(parse_fasta_bytes(fasta), min_read_length=500)
    kt = select_kmers_random(8, 0.1, seed=231)
    markers = find_markers(store, kt)
    cand = LH.find_candidates_lowhash(
        markers,
        LH.LowHashParams(
            m=4, hash_fraction=0.05, iteration_count=6, min_frequency=2,
            max_bucket_size=60,
        ),
    )
    return markers, kt, cand


def workload_runner(markers, kt, cand, device):
    """bench.py's ``run()`` (:203-218) on the workload: ``run()`` aligns
    every candidate with ``align_candidates`` (method 3,
    AlignParams(20, 60, 60, 60)) on ``device`` and returns the
    AlignmentStore; the downsampling table is built here, before."""
    from shasta_tpu_torch.ops.align import AlignParams, align_candidates

    params = AlignParams(**ALIGN)
    ds_table = kt.downsampling_hash_table()

    def run():
        return align_candidates(
            markers, cand.read_id0, cand.read_id1, cand.same_strand, params, ds_table,
            device=device,
        )

    return run


def roofline_batch(seed=11):
    """bench.py:86-103: (a, a_len, b, b_len, band_min), numpy int32, 1024
    pairs at LA = LB = 512 (lengths 380 to 499, b a shifted copy of a
    with 12 % of its markers redrawn), band_min -64; W is 128."""
    B, LA, LB = 1024, 512, 512
    rng = np.random.default_rng(seed)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LB), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.full(B, -64, np.int32)
    for t in range(B):
        g = rng.integers(0, 8000, LB + 120).astype(np.int32)
        la = int(rng.integers(380, 500))
        lb = int(rng.integers(380, 500))
        sb = int(rng.integers(0, 40))
        a[t, :la] = g[:la]
        bb = g[sb : sb + lb].copy()
        nz = rng.random(lb) < 0.12
        bb[nz] = rng.integers(0, 8000, nz.sum())
        b[t, :lb] = bb
        a_len[t], b_len[t] = la, lb
    return a, a_len, b, b_len, bm


def ceiling_tile(seed=23):
    """bench.py:158: the (1024, 512) int32 tile of the ceiling."""
    rng = np.random.default_rng(seed)
    return rng.integers(-1000, 1000, (1024, 512)).astype(np.int32)


def seconds(device, fn):
    """Seconds of ``fn()``: CUDA events around it on the current stream,
    waited for, on the card; the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def marginal(device, fn, K0, K1):
    """Seconds of one of ``fn(K)``'s K steps: fn(K1) against fn(K0). Raises
    when the difference is not positive."""
    t_short = seconds(device, lambda: fn(K0))
    t_long = seconds(device, lambda: fn(K1))
    per = (t_long - t_short) / (K1 - K0)
    if per <= 0:
        raise RuntimeError(
            f"the timing failed: K {K1} took {t_long:.6f}s against {t_short:.6f}s at K {K0}"
        )
    return per


def graphed(fn):
    """``fn()`` (no arguments, a tensor out) captured in a CUDA graph:
    a function that replays it and returns the graph's output tensor.
    ``fn`` runs once on a side stream before the capture (torch's warm-up
    rule); raises unless the first replay gives that call's output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    if not torch.equal(out, want):
        raise RuntimeError("a CUDA graph's replay differs from the call it captured")

    def replay():
        graph.replay()
        return out

    return replay


def kernel_roofline_prepare(device, seed=11, K0=2, K1=26):
    """(``rep()``, ``eager()``): ``rep()`` gives one (Gcells/s, pairs/s)
    estimate of ``banded_align_pairs`` on :func:`roofline_batch`
    (bench.py:64): K calls, ``b`` rolled by the call's index, outputs
    summed on the device, K1 against K0, each chain a CUDA graph's
    replay on the card; ``eager()`` gives the same estimate of the chain
    called from Python. Each chain runs once before, both ways (the
    graphs' warm-up runs on a stream of its own, whose cached memory the
    current stream does not reuse)."""
    a, a_len, b, b_len, bm = (torch.from_numpy(x).to(device) for x in roofline_batch(seed))
    B, LA = a.shape
    LB, W = b.shape[1], ROOFLINE_W
    kw = dict(LA=LA, LB=LB, W=W, **SCORES)

    def chain(K):
        acc = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(K):
            acc += AK.banded_align_pairs(a, a_len, torch.roll(b, i, 0), b_len, bm, **kw).sum()
        return acc

    if device.type == "cuda":
        runs = {K: graphed(functools.partial(chain, K)) for K in (K0, K1)}
    else:
        runs = {K: functools.partial(chain, K) for K in (K0, K1)}
    for K in (K0, K1):
        seconds(device, runs[K])
        seconds(device, functools.partial(chain, K))

    def rates(fn):
        per = marginal(device, fn, K0, K1)
        return B * LA * W / per / 1e9, B / per

    return (lambda: rates(lambda K: runs[K]())), (lambda: rates(chain))


def int32_peak_prepare(device, K0=256, K1=8448):
    """A ``rep()`` giving one int32 ops/s estimate of the card
    (bench.py:143): ``peak.int32_chain`` over :func:`ceiling_tile`, K1
    against K0 iterations, peak.OPS_PER_ITERATION operations an element
    and iteration. The kernel is run at both K once before."""
    x = torch.from_numpy(ceiling_tile()).to(device)
    seconds(device, lambda: peak.int32_chain(x, K0))
    seconds(device, lambda: peak.int32_chain(x, K1))

    def rep():
        per = marginal(device, lambda K: peak.int32_chain(x, K), K0, K1)
        return x.numel() * peak.OPS_PER_ITERATION / per

    return rep


def busy_share(label, fn) -> float:
    """The card's busy share during ``fn()``, from the card idle to the
    card idle: the summed device time of the DP kernels' launches
    (align_kernel.TRACE) over the wall time."""
    AK.TRACE = []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy = sum(s.elapsed_time(e) for *_, s, e in AK.TRACE) / 1e3
    finally:
        AK.TRACE = None
    say(f"busy share of {label}: {busy / wall} ({busy:.6f}s of DP kernels in {wall:.6f}s "
        "wall)")
    return busy / wall


def describe_card() -> float:
    """Print the card's name, power limit and SM clock, the data sheet's
    int32 rate and the issue limit; return the data sheet's rate."""
    say(f"card {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {peak.nvidia_smi('name,power.limit')}")
    mhz = float(peak.nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"SM clock: max {mhz:.0f} MHz, now {peak.nvidia_smi('clocks.sm')}, {sms} SMs")
    rate = peak.data_sheet_int32_ops(mhz, sms)
    say(f"data sheet int32 rate: {rate / 1e9} Gops/s ({sms} SMs x "
        f"{peak.INT32_LANES_PER_SM} lanes x {mhz:.0f} MHz); issue limit "
        f"{peak.issue_limit_ops(mhz, sms) / 1e9} Gops/s ({peak.ISSUE_LANES_PER_SM} lanes)")
    return rate


def parse_args(argv):
    p = argparse.ArgumentParser(
        prog="python -m shasta_tpu_torch.bench",
        description="Marker alignments per second on one card (bench.py's port).",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--reps", type=int, default=12, help="timed reps of each kind")
    args = p.parse_args(argv)
    if args.reps < 1:
        p.error("--reps must be at least 1")
    return args


def main(argv=None) -> int:
    from shasta_tpu_torch.parallel.context import use_mesh
    from shasta_tpu_torch.parallel.mesh import make_mesh

    args = parse_args(argv)
    dev = AK.resolve_device(args.device)
    if dev.type == "cuda":
        say(f"kernel build {AK.build_kernels():.2f}s (0: built before)")
        data_sheet = describe_card()
    else:
        say("device cpu: every kernel's plain PyTorch version; no number here is a card's")

    t0 = time.perf_counter()
    markers, kt, cand = build_workload()
    run = workload_runner(markers, kt, cand, dev)
    say(f"workload: {cand.count} candidates, {markers.oriented_read_count} oriented reads, "
        f"{markers.kmer_ids.shape[0]} markers; built in {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    kept = run().count
    say(f"warm-up align_candidates: {time.perf_counter() - t0:.3f}s, {kept} alignments kept")
    best = best_mesh = 0.0
    host_s, mesh_s = [], []
    created = not dist.is_initialized()
    try:
        mesh1 = make_mesh(1, device=dev)
        with use_mesh(mesh1):
            run()
        bench_start = time.monotonic()
        for _ in range(args.reps):
            t0 = time.monotonic()
            run()
            host_s.append(time.monotonic() - t0)
            best = max(best, cand.count / host_s[-1])
            with use_mesh(mesh1):
                t0 = time.monotonic()
                run()
                mesh_s.append(time.monotonic() - t0)
            best_mesh = max(best_mesh, cand.count / mesh_s[-1])
            if time.monotonic() - bench_start > TIMED_REPS_CAP_S:
                break
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
    say(f"align_candidates seconds: host {host_s}, mesh1 {mesh_s}; best {best} and "
        f"{best_mesh} alignments/s")
    if dev.type == "cuda":
        busy_share("one align_candidates", run)

    k_rep, k_eager = kernel_roofline_prepare(dev)
    v_rep = int32_peak_prepare(dev)
    gcells = kernel_pairs = gcells_chunked = vpu_gops = 0.0
    for _ in range(KERNEL_REPS):
        g, p = k_rep()
        if g > gcells:
            gcells, kernel_pairs = g, p
        vpu_gops = max(vpu_gops, v_rep() / 1e9)
        gcells_chunked = max(gcells_chunked, k_rep()[0])
    say(f"roofline {gcells} Gcells/s, {kernel_pairs} pairs/s; chunked rep {gcells_chunked} "
        f"Gcells/s; int32 ceiling {vpu_gops} Gops/s")
    if dev.type == "cuda":
        say(f"roofline called from Python (the host's enqueue included): {k_eager()[0]} "
            f"Gcells/s, against {gcells} from CUDA graph replays")
        say(f"int32 ceiling / data sheet: {vpu_gops * 1e9 / data_sheet}; SM clock now "
            f"{peak.nvidia_smi('clocks.sm')}")
    say("launches " + json.dumps({**AK.LAUNCHES, **peak.LAUNCHES}))

    ops_per_cell = AK.FWD_INT_OPS_PER_CELL
    pct_peak = 100.0 * gcells * ops_per_cell / vpu_gops
    print(json.dumps({
        "metric": "marker_alignments_per_sec_per_chip",
        "value": round(best, 1),
        "unit": "alignments/s",
        "vs_baseline": round(best / REFERENCE_ALIGNMENTS_PER_SEC, 4),
        "mesh1_alignments_per_sec": round(best_mesh, 1),
        "mesh1_host_ratio": round(best_mesh / best, 3),
        "kernel_gcells_per_sec": round(gcells, 2),
        "kernel_chunked_gcells_per_sec": round(gcells_chunked, 2),
        "kernel_pairs_per_sec": round(kernel_pairs, 0),
        "kernel_ops_per_cell": ops_per_cell,
        "vpu_peak_gops": round(vpu_gops, 1),
        "kernel_pct_peak": round(pct_peak, 1),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
