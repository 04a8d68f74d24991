"""The port's own spans (``utils/perf.py:span``) under ``torch.profiler``:
each ``PerformanceLog`` stage opens ``stage:<name>``, and one
computeAlignments (method 3, device="cpu") opens each of its five step
spans once, inside the stage, with a span ``stage:align.fetch`` around every
blocking device-to-host fetch. Under a profiler the stages still hash
to the pinned golden values."""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shasta_tpu_torch.data import kmers
from shasta_tpu_torch.pipeline.assemble import Assembler
from shasta_tpu_torch.utils import synth
from shasta_tpu_torch.utils.perf import PerformanceLog
from tests.test_torch_pipeline import GOLDEN, port_small_config, run_six, stage_hashes
from tests.torch_common import one_torch_thread  # noqa: F401

STEPS = [f"stage:align.{s}" for s in ("prep", "phase1", "phase2", "collect", "store")]
STAGE = "stage:computeAlignments"


def cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


def spans_of(prof):
    """(start, end, name) in ns of the profile's program spans."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU and ev.name().startswith("stage:"):
            out.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
    return sorted(out)


def inside(span, outers):
    return any(s <= span[0] and span[1] <= e for s, e, _ in outers)


def named(spans, name):
    return [x for x in spans if x[2] == name]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The golden input's six stages, then computeAlignments once more,
    all under one profiler: two calls of computeAlignments."""
    d = tmp_path_factory.mktemp("trace")
    genome = synth.random_genome(25000, seed=4242)
    fasta = str(d / "reads.fasta")
    synth.write_fasta(fasta, synth.sample_reads(genome, 130, 3000, seed=4243, both_strands=True))
    asm = Assembler(str(d / "run"), port_small_config(), device="cpu")
    # The table is cached per process: empty the cache so that it is
    # built under the profiler whatever this worker ran before.
    kmers._TABLES.clear()
    with cpu_profiler() as prof:
        run_six(asm, fasta)
        asm.compute_alignments()
    spans = spans_of(prof)
    return {
        "spans": spans,
        "calls": named(spans, STAGE),
        "hashes": stage_hashes(str(d / "run")),
        "stage_seconds": asm.log.stage_seconds,
    }


@pytest.mark.parametrize("name", STEPS)
def test_step_span_once_per_call_inside_the_stage(traced, name):
    calls = traced["calls"]
    assert len(calls) == 2
    got = named(traced["spans"], name)
    assert len(got) == 2
    assert [sum(inside(x, [c]) for x in got) for c in calls] == [1, 1]


def test_steps_in_order_and_fetches_inside_phase2_and_collect(traced):
    spans = traced["spans"]
    for i in range(2):
        steps = [named(spans, n)[i] for n in STEPS]
        assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:]))
    fetches = [f for f in named(spans, "stage:align.fetch") if inside(f, traced["calls"])]
    phase2, collect = named(spans, "stage:align.phase2"), named(spans, "stage:align.collect")
    assert all(inside(f, phase2) or inside(f, collect) for f in fetches)
    assert any(inside(f, phase2) for f in fetches)
    assert any(inside(f, collect) for f in fetches)


def test_every_stage_opens_its_span(traced):
    """Each stage opens ``stage:<name>`` once a call, and
    ``stage_seconds`` still times every one (step spans, named
    ``stage:<stage>.<step>``, left out). The k-mer table's build opens
    ``stage:kmers.table`` once."""
    names = [n for _, _, n in traced["spans"] if "." not in n[len("stage:"):]]
    assert sorted(set(names)) == sorted(f"stage:{k}" for k in traced["stage_seconds"])
    assert len(names) == len(traced["stage_seconds"]) + 1 == 7
    assert all(v > 0 for v in traced["stage_seconds"].values())
    assert len(named(traced["spans"], "stage:kmers.table")) == 1


def test_stage_hashes_pinned_under_a_profiler(traced):
    """As ``test_torch_pipeline.py`` holds them without one."""
    with open(GOLDEN) as f:
        pinned = json.load(f)
    for stage in ["Reads", "Kmers", "Markers", "AlignmentCandidates", "Alignments"]:
        assert traced["hashes"][stage] == pinned[stage], stage


@pytest.mark.parametrize("traced", [False, True])
def test_performance_log_stage_span_and_seconds(traced):
    log = PerformanceLog()
    with cpu_profiler() if traced else contextlib.nullcontext() as p:
        for _ in range(2):
            with log.stage("x"):
                torch.ones(4).sum()
    assert set(log.stage_seconds) == {"x"} and log.stage_seconds["x"] > 0
    if traced:
        assert [n for _, _, n in spans_of(p)] == ["stage:x", "stage:x"]


def test_span_names_read_as_spans_without_an_activity_type(traced):
    """Where the profiler's events carry no activity type (torch 2.11),
    the benchmark's trace reads a range as a program span, and not as
    device work, by its name alone: every span the program opens."""
    from perfbench.trace import _is_annotation

    class Event:
        def __init__(self, name):
            self._name = name

        def name(self):
            return self._name

    names = {n for _, _, n in traced["spans"]}
    lowhash = {f"stage:lowhash.{s}" for s in ("hash", "group", "pairs")}
    assert {"stage:align.fetch", *STEPS, *lowhash} <= names
    assert all(_is_annotation(Event(n)) for n in names)
