"""The loops a window can run, named by a traffic file's ``driver``.

Each driver builds the cell's inputs from the seed, sets the program up
(counted in ``setup_s``), warms every path the window takes, then runs
whole units of work back to back until ``--seconds`` have passed; the
unit in flight at the deadline is finished and counted, and the window
ends with it. It returns a :class:`Result`: the record the metric
readers read, the device line, the trace breakdown, and ``check()``,
which compares what the window produced with the plain reference once
the window has closed and the program's state is freed.

- ``assemble``: ``run_assembly`` on the reads, each run into a fresh
  run directory (the previous one deleted).
- ``align``: one ``Assembler`` set up through findAlignmentCandidates,
  then ``compute_alignments`` (computeAlignments, the stage the
  ``ComputeAlignments.py`` driver re-runs) pass after pass.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import gen, grade, harness, reference, trace

ALIGN_FIELDS = ("marker_count", "first0", "last0", "first1", "last1", "min_offset",
                "max_offset", "max_skip_v", "max_drift_v", "n_markers0", "n_markers1")


@dataclass
class Result:
    record: dict
    device: dict
    breakdown: Optional[dict]
    check: Callable[[], Dict[str, dict]]


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


class Inputs:
    """The genome and reads of one run, from the configuration's read
    model, the traffic's genome size and the run's seed."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, work: str):
        s_genome, s_reads, self.s_sample = harness.seeds(seed, 3)
        rm = cfg["reads"]
        g_len = int(traffic["genome_bases"])
        self.genome = gen.random_genome(g_len, s_genome)
        lengths = gen.read_lengths(g_len, rm["coverage"], rm["median_length"], rm["sigma"],
                                   rm["min_length"], rm["length_seed"])
        self.reads = gen.sample_reads_fixed(
            self.genome, lengths, seed=s_reads, error_rate=rm["error_rate"],
            mix=tuple(rm["mix"]), homopolymer_bias=rm["homopolymer_bias"],
        )
        self.fasta = os.path.join(work, "reads.fasta")
        gen.write_fasta(self.fasta, self.reads)
        self.params = reference.Params.from_config(cfg)
        # The program's read ids: the reads it keeps (by their length as
        # written, errors and all), in FASTA order.
        self.lengths = np.array([r.shape[0] for r in self.reads], np.int64)
        self.kept = np.flatnonzero(self.lengths >= self.params.min_read_length)

    def markers(self, read_ids) -> reference.Markers:
        rle = {int(r): reference.rle(self.reads[self.kept[int(r)]]) for r in read_ids}
        return reference.Markers(rle, self.params)

    def sample(self, r0: np.ndarray, r1: np.ndarray, n_random: int, n_longest: int) -> np.ndarray:
        """Candidate indices to check: the ``n_longest`` whose shorter
        read is longest, and ``n_random`` more drawn from the seed."""
        n = r0.shape[0]
        lens = self.lengths[self.kept]
        shorter = np.minimum(lens[r0], lens[r1])
        longest = np.argsort(-shorter, kind="stable")[:n_longest]
        rest = np.setdiff1d(np.arange(n), longest)
        rng = np.random.default_rng(self.s_sample)
        pick = rng.choice(rest, size=min(n_random, rest.shape[0]), replace=False)
        return np.sort(np.concatenate([longest, pick]))


def assembly_config(cfg: dict):
    from shasta_tpu_torch.pipeline.config import AssemblyConfig

    return AssemblyConfig.from_conf_text(cfg["conf"])


# ---------------------------------------------------------------------------
# The program's answers and the reference's
# ---------------------------------------------------------------------------


def answers(al: dict, r0, r1, ss) -> List[Optional[dict]]:
    """The program's alignment (fields as in its Alignments stage) of
    each candidate (r0, r1, ss), or None."""
    key = (al["read_id0"].astype(np.int64) << 33) | (al["read_id1"].astype(np.int64) << 1) \
        | al["same_strand"].astype(np.int64)
    want = (np.asarray(r0, np.int64) << 33) | (np.asarray(r1, np.int64) << 1) \
        | np.asarray(ss, np.int64)
    order = np.argsort(key, kind="stable")
    pos = np.minimum(np.searchsorted(key[order], want), max(key.shape[0] - 1, 0))
    out: List[Optional[dict]] = []
    for q, k in enumerate(want):
        if key.shape[0] == 0 or key[order[pos[q]]] != k:
            out.append(None)
            continue
        i = int(order[pos[q]])
        lo, hi = int(al["offsets"][i]), int(al["offsets"][i + 1])
        a = {f: int(al[f][i]) for f in ALIGN_FIELDS}
        a["ord0"] = al["ord0"][lo:hi].astype(np.int64)
        a["ord1"] = al["ord1"][lo:hi].astype(np.int64)
        out.append(a)
    return out


def store_arrays(store) -> dict:
    return {f: getattr(store, f) for f in store.__dataclass_fields__}


def judge(inputs: Inputs, r0, r1, ss, got_per_unit: List[List[Optional[dict]]],
          device) -> Dict[str, dict]:
    """The sampled candidates' answers in every unit of the window, held
    against the reference's (``reference.mismatched``)."""
    cands = [(int(a), int(b), bool(s)) for a, b, s in zip(r0, r1, ss)]
    mk = inputs.markers(set(r0.tolist()) | set(r1.tolist()))
    t0 = time.monotonic()
    bad, aligned = reference.mismatched(mk, cands, inputs.params, device, got_per_unit)
    harness.log(f"reference: {len(cands)} candidates, {aligned} aligned, "
                f"{len(got_per_unit)} units checked, {time.monotonic() - t0:.1f} s")
    return {"mismatched_alignments": {"value": int(bad), "limit": 0}}


def assembly_checks(fastas: List[bytes], genome: np.ndarray, limits: dict) -> Dict[str, dict]:
    """Each assembly graded against the genome (grade.py); the worst
    over them: estimated base errors per 100 kb of contig, and the share
    of the genome's distinct 21-mers that the contigs miss, in %."""
    worst = {"contig_errors_per_100kb": 0.0, "genome_missing_pct": 0.0}
    for data in fastas:
        g = grade.qv_completeness(grade.contigs_of(data), genome)
        harness.log(f"assembly: QV {g['qv']:.2f}, completeness {g['completeness']:.6f}")
        worst["contig_errors_per_100kb"] = max(worst["contig_errors_per_100kb"],
                                               1e5 * g["base_error"])
        worst["genome_missing_pct"] = max(worst["genome_missing_pct"],
                                          100.0 * (1.0 - g["completeness"]))
    return {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------


class Window:
    """Runs units until the deadline; with ``traced``, under the
    profiler, the program's stage spans and the kernels' launch trace."""

    def __init__(self, seconds: float, traced: bool, device):
        self.seconds = seconds
        self.traced = traced
        self.cuda = torch.device(device).type == "cuda"
        self.units = 0
        self.unit_s: List[float] = []
        self.trace: Optional[trace.Trace] = None
        self.launch_trace = None

    def run(self, unit: Callable[[int], None], name: str):
        from shasta_tpu_torch.ops import align_kernel as AK

        self.sync()
        launches0 = sum(AK.LAUNCHES.values())
        stack = []
        if self.traced:
            AK.TRACE = []
            prof = trace.profiler()
            prof.__enter__()
            stages = trace.stage_spans()
            stages.__enter__()
            stack = [stages, prof]
        rss = harness.PeakSampler()
        t0 = time.monotonic()
        try:
            while True:
                t_unit = time.monotonic()
                with trace.span(name):
                    unit(self.units)
                self.sync()
                self.units += 1
                self.unit_s.append(time.monotonic() - t_unit)
                if time.monotonic() - t0 >= self.seconds:
                    break
        finally:
            self.window_s = time.monotonic() - t0
            self.host_peak = rss.stop()
            self.device_peak = torch.cuda.max_memory_allocated() if self.cuda else 0
            for ctx in stack:
                ctx.__exit__(None, None, None)
            if self.traced:
                self.trace = trace.Trace.from_profiler(stack[-1])
                self.launch_trace, AK.TRACE = AK.TRACE, None
        self.launches = sum(AK.LAUNCHES.values()) - launches0
        harness.log(f"window: {self.units} {name} in {self.window_s:.3f} s, "
                    f"{self.launches} DP launches; each {[round(x, 3) for x in self.unit_s]} s")

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def dp_bound_s(self) -> Optional[float]:
        """The least time of the window's DP launches, forward and
        traceback (roofline.py)."""
        if not self.launch_trace:
            return None
        from perfbench import roofline

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock = max_sm_clock_mhz()
        return 1e-3 * sum(roofline.launch_bound_ms(name, work, LA, W, B, clock, sms)
                          for name, _body, LA, W, B, work, _s, _e in self.launch_trace)

    def record(self, setup_s: float, **extra) -> dict:
        rec = dict(setup_s=setup_s, window_s=self.window_s, items=self.units,
                   host_peak_bytes=self.host_peak, launches=self.launches, trace=None,
                   dp_bound_s=None)
        if self.trace is not None:
            rec.update(trace=self.trace, dp_bound_s=self.dp_bound_s())
        rec.update(extra)
        return rec

    def device(self) -> dict:
        kind = torch.cuda.get_device_name(0) if self.cuda else "cpu"
        dev = {"platform": "gpu" if self.cuda else "cpu", "kind": kind, "count": 1,
               "memory_peak_bytes": int(self.device_peak)}
        if self.trace is not None:
            dev.update(busy_s=self.trace.busy_seconds(), window_s=self.window_s)
        return dev

    def breakdown(self) -> Optional[dict]:
        if self.trace is None:
            return None
        return {"device_ops": self.trace.device_ops(), "idle_gaps": self.trace.idle_gaps()}


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock (nvidia-smi), else the H100 SXM's."""
    import subprocess

    from perfbench import roofline

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return roofline.H100_MAX_SM_MHZ


def release_device(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# assemble
# ---------------------------------------------------------------------------


def drive_assemble(cfg, traffic, args, work, device, t_process) -> Result:
    from shasta_tpu_torch.pipeline.assemble import run_assembly

    t0 = time.monotonic()
    inputs = Inputs(cfg, traffic, args.seed, work)
    t1 = time.monotonic()
    conf = assembly_config(cfg)
    warm = os.path.join(work, "warm")
    summary = run_assembly([inputs.fasta], warm, conf, device=device)
    shutil.rmtree(warm)
    harness.log(f"set-up: to the harness {t0 - t_process:.2f} s, inputs {t1 - t0:.2f} s, "
                f"warm assembly {time.monotonic() - t1:.2f} s (stages "
                f"{json.dumps({k: round(v, 2) for k, v in summary['stageSeconds'].items()})})")
    runs: List[str] = []
    stage_seconds: List[dict] = []
    fastas: Dict[str, bytes] = {}  # each distinct Assembly.fasta of the window, by sha256

    def unit(i: int) -> None:
        rd = os.path.join(work, f"run{i}")
        summary = run_assembly([inputs.fasta], rd, conf, device=device)
        stage_seconds.append(dict(summary["stageSeconds"]))
        with open(os.path.join(rd, "Assembly.fasta"), "rb") as f:
            data = f.read()
        fastas.setdefault(hashlib.sha256(data).hexdigest(), data)
        if runs:
            shutil.rmtree(runs.pop())
        runs.append(rd)

    window = Window(args.seconds, bool(args.trace), device)
    setup_s = time.monotonic() - t_process
    window.run(unit, "assembly")
    record = window.record(setup_s, kind="assemble", stage_seconds=stage_seconds,
                           candidates=None)
    totals = {k: round(sum(s.get(k, 0.0) for s in stage_seconds), 2) for k in stage_seconds[0]}
    harness.log(f"window stages (s, summed over its assemblies): {json.dumps(totals)}")

    def check() -> Dict[str, dict]:
        release_device(device)
        rd = runs[-1]
        data = os.path.join(rd, "Data")

        def stage(name):
            d = os.path.join(data, name)
            return {f[:-4]: np.load(os.path.join(d, f)) for f in os.listdir(d) if f.endswith(".npy")}

        cand = stage("AlignmentCandidates")
        al = stage("Alignments")
        shutil.rmtree(rd, ignore_errors=True)
        n_r, n_l = traffic["check"]["random"], traffic["check"]["longest"]
        q = inputs.sample(cand["read_id0"], cand["read_id1"], n_r, n_l)
        r0, r1, ss = cand["read_id0"][q], cand["read_id1"][q], cand["same_strand"][q]
        checks = judge(inputs, r0, r1, ss, [answers(al, r0, r1, ss)], device)
        checks.update(assembly_checks(list(fastas.values()), inputs.genome,
                                      traffic["check"]["assembly"]))
        harness.log(f"{len(fastas)} distinct Assembly.fasta over {window.units} assemblies")
        return checks

    return Result(record, window.device(), window.breakdown(), check)


# ---------------------------------------------------------------------------
# align
# ---------------------------------------------------------------------------


def drive_align(cfg, traffic, args, work, device, t_process) -> Result:
    from shasta_tpu_torch.pipeline.assemble import Assembler

    t0 = time.monotonic()
    inputs = Inputs(cfg, traffic, args.seed, work)
    t1 = time.monotonic()
    a = Assembler(os.path.join(work, "run"), assembly_config(cfg), device=device)
    a.add_reads([inputs.fasta])
    a.select_kmers()
    a.find_markers()
    a.flag_palindromic_reads()
    a.find_alignment_candidates()
    t2 = time.monotonic()
    a.kmer_table.downsampling_hash_table()
    t3 = time.monotonic()
    c = a.candidates
    n_r, n_l = traffic["check"]["random"], traffic["check"]["longest"]
    q = inputs.sample(c.read_id0, c.read_id1, n_r, n_l)
    r0, r1, ss = c.read_id0[q].copy(), c.read_id1[q].copy(), c.same_strand[q].copy()
    a.compute_alignments()  # the warm pass
    harness.log(f"set-up: to the harness {t0 - t_process:.2f} s, inputs {t1 - t0:.2f} s, "
                f"stages to candidates {t2 - t1:.2f} s "
                f"{json.dumps({k: round(v, 2) for k, v in a.log.stage_seconds.items()})}, "
                f"downsampling table {t3 - t2:.2f} s, warm pass {time.monotonic() - t3:.2f} s")
    got: List[List[Optional[dict]]] = []

    def unit(_i: int) -> None:
        a.compute_alignments()
        got.append(answers(store_arrays(a.alignments), r0, r1, ss))

    window = Window(args.seconds, bool(args.trace), device)
    setup_s = time.monotonic() - t_process
    window.run(unit, "pass")
    n_cand = int(c.count)
    record = window.record(setup_s, kind="align", stage_seconds=None,
                           candidates=n_cand * window.units)
    harness.log(f"align: {n_cand} candidates, {a.alignments.count} alignments a pass")

    def check() -> Dict[str, dict]:
        nonlocal a
        a = None
        release_device(device)
        return judge(inputs, r0, r1, ss, got, device)

    return Result(record, window.device(), window.breakdown(), check)


DRIVERS = {"assemble": drive_assemble, "align": drive_align}
