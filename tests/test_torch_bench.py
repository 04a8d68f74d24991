"""The port's bench entry point (shasta_tpu_torch.bench) against the
repository root's bench.py and the JAX package, on the CPU.

The workload is shrunk by monkeypatching the bench module's functions that
build its inputs (no flag of the bench does it). Every comparison of the workload, the
alignments and the DP is exact equality of integer arrays; the int32
chain is compared modulo 2**32 (its adds wrap).
"""

import functools
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import bench as REF
import shasta_tpu.ops.align_pallas as AP
from shasta_tpu.ops import align as RA
from shasta_tpu_torch import bench as PB
from shasta_tpu_torch.ops import align_kernel as K
from shasta_tpu_torch.utils import peak
from tests.torch_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A few hundred reads of 1500 bases (about 1,900 candidates), LowHash as
# bench.py has it.
SMALL = dict(n_reads=200, read_len=1500, genome_size=30000)
# bench.py's JSON line, in its order (bench.py:303-320).
KEYS = [
    "metric", "value", "unit", "vs_baseline", "mesh1_alignments_per_sec",
    "mesh1_host_ratio", "kernel_gcells_per_sec", "kernel_chunked_gcells_per_sec",
    "kernel_pairs_per_sec", "kernel_ops_per_cell", "vpu_peak_gops", "kernel_pct_peak",
]


@pytest.fixture(scope="module")
def workloads():
    """(port's workload, bench.py's) at SMALL."""
    return PB.build_workload(**SMALL), REF.build_workload(**SMALL)


@pytest.mark.parametrize("part", ["markers", "candidates"])
def test_workload_equals_bench_py(workloads, part):
    """build_workload gives bench.py's markers and candidates, array for
    array, dtypes included."""
    (markers, _, cand), (ref_markers, _, ref_cand) = workloads
    got, ref = (markers, ref_markers) if part == "markers" else (cand, ref_cand)
    ga, ra = got.arrays(), ref.arrays()
    assert sorted(ga) == sorted(ra)
    for k, v in ra.items():
        assert np.asarray(ga[k]).dtype == np.asarray(v).dtype, k
        assert np.array_equal(ga[k], v), k
    assert cand.count > 1000


def test_run_equals_jax_align_candidates(workloads):
    """The bench's run() on the CPU gives the JAX align_candidates'
    AlignmentStore exactly (bench.py:203-218's call)."""
    (markers, kt, cand), (ref_markers, ref_kt, ref_cand) = workloads
    got = PB.workload_runner(markers, kt, cand, torch.device("cpu"))()
    ref = RA.align_candidates(
        ref_markers, ref_cand.read_id0, ref_cand.read_id1, ref_cand.same_strand,
        RA.AlignParams(min_aligned_marker_count=20, max_skip=60, max_drift=60, max_trim=60),
        ref_kt.downsampling_hash_table(),
    )
    ga, ra = got.arrays(), ref.arrays()
    assert sorted(ga) == sorted(ra)
    for k, v in ra.items():
        assert ga[k].dtype == v.dtype, k
        assert np.array_equal(ga[k], v), k
    assert got.count > 1000


def bench_py_roofline_batch(seed=11):
    """bench.py:86-103, as it stands there."""
    B, LA, LB, W = 1024, 512, 512, 128
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


@pytest.fixture
def interpret_mode(monkeypatch):
    """The JAX kernel in Pallas interpret mode with int32 transfers (as
    tests/test_torch_align_kernel.py runs it)."""
    monkeypatch.setattr(
        AP.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    monkeypatch.setenv("SHASTA_TPU_INT16", "0")
    AP.banded_align_pairs.clear_cache()
    yield
    AP.banded_align_pairs.clear_cache()


def test_roofline_batch_and_its_dp(interpret_mode):
    """The roofline batch equals bench.py's; its first 8 pairs through the
    port's banded_align_pairs equal the JAX banded_align_pairs (Pallas,
    interpret mode) on the whole fused output."""
    got = PB.roofline_batch()
    ref = bench_py_roofline_batch()
    for g, r in zip(got, ref, strict=True):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    kw = dict(LA=512, LB=512, W=PB.ROOFLINE_W, **PB.SCORES)
    eight = [x[:8] for x in got]
    port = K.banded_align_pairs(*(torch.from_numpy(x) for x in eight), **kw).numpy()
    jax_out = np.asarray(AP.banded_align_pairs(*(jnp.asarray(x) for x in eight), **kw))
    assert port.dtype == jax_out.dtype == np.int32
    assert np.array_equal(port, jax_out)
    assert (port[:, 0] > 300).all()  # every pair aligns most of its markers


def jnp_chain(x, K):
    """bench.py:164-177's loop body, as it stands there, K iterations."""
    def body(i, y):
        y = y + i
        y = y ^ jnp.int32(-1640531527)
        y = jnp.maximum(y, i)
        y = y + y
        y = y ^ i
        y = jnp.minimum(y, jnp.int32(1 << 30))
        y = y + jnp.int32(13)
        y = y ^ (i + 1)
        return y

    return np.asarray(jax.lax.fori_loop(0, K, body, jnp.asarray(x)))


@pytest.mark.parametrize("K", [1, 2, 3, 17])
@pytest.mark.parametrize("values", ["bench", "full"])
def test_int32_chain_plain_equals_jnp(K, values):
    """int32_chain_plain (and the wrapper on a CPU tensor) equals the JAX
    chain modulo 2**32 on a (64, 32) tile: bench.py's value range, and the
    whole int32 range (the chain reaches a fixed point within a few
    iterations on bench.py's range)."""
    rng = np.random.default_rng(K)
    if values == "bench":
        x = rng.integers(-1000, 1000, (64, 32)).astype(np.int32)
    else:
        x = rng.integers(-(2**31), 2**31, (64, 32)).astype(np.int32)
    ref = jnp_chain(x, K).astype(np.int64) % 2**32
    for fn in (peak.int32_chain_plain, peak.int32_chain):
        got = fn(torch.from_numpy(x), K)
        assert got.dtype == torch.int32 and got.shape == (64, 32)
        assert np.array_equal(got.numpy().astype(np.int64) % 2**32, ref)


def test_main_prints_bench_py_line(monkeypatch, capsys):
    """main on the CPU, shrunk by monkeypatching: one stdout line, bench.py's
    12 keys in order, finite values, and vs_baseline, mesh1_host_ratio and
    kernel_pct_peak by bench.py's formulas."""
    orig = {n: getattr(PB, n) for n in (
        "build_workload", "roofline_batch", "ceiling_tile", "kernel_roofline_prepare",
        "int32_peak_prepare",
    )}
    monkeypatch.setattr(PB, "build_workload", functools.partial(
        orig["build_workload"], n_reads=100, read_len=1500, genome_size=15000))
    monkeypatch.setattr(PB, "roofline_batch", lambda seed=11: tuple(
        x[:2].copy() for x in orig["roofline_batch"](seed)))
    monkeypatch.setattr(
        PB, "ceiling_tile", lambda seed=23: orig["ceiling_tile"](seed)[:64, :32].copy())
    monkeypatch.setattr(PB, "kernel_roofline_prepare", functools.partial(
        orig["kernel_roofline_prepare"], K0=1, K1=2))
    monkeypatch.setattr(PB, "int32_peak_prepare", functools.partial(
        orig["int32_peak_prepare"], K0=1, K1=33))
    monkeypatch.setattr(PB, "KERNEL_REPS", 1)
    assert PB.main(["--device", "cpu", "--reps", "1"]) == 0
    out = capsys.readouterr()
    lines = out.out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == KEYS
    assert line["metric"] == "marker_alignments_per_sec_per_chip"
    assert line["unit"] == "alignments/s"
    nums = {k: v for k, v in line.items() if k not in ("metric", "unit")}
    assert all(isinstance(v, (int, float)) and math.isfinite(v) for v in nums.values())
    assert line["value"] > 0 and line["mesh1_alignments_per_sec"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 7400, abs=1e-4)
    assert line["mesh1_host_ratio"] == pytest.approx(
        line["mesh1_alignments_per_sec"] / line["value"], abs=2e-3)
    assert line["kernel_ops_per_cell"] == K.FWD_INT_OPS_PER_CELL == 13
    # The kernel rates unrounded (stderr): on the CPU they round to 0.
    m = re.search(r"roofline (\S+) Gcells/s, \S+ pairs/s; chunked rep (\S+) Gcells/s; "
                  r"int32 ceiling (\S+) Gops/s", out.err)
    gcells, chunked, gops = (float(x) for x in m.groups())
    assert gcells > 0 and chunked > 0 and gops > 0
    assert line["kernel_gcells_per_sec"] == round(gcells, 2)
    assert line["vpu_peak_gops"] == round(gops, 1)
    assert line["kernel_pct_peak"] == round(100 * gcells * 13 / gops, 1)
    assert "no number here is a card's" in out.err
    assert "launches" in out.err


def test_device_cuda_without_a_card_exits_non_zero():
    """With no card, `python -m shasta_tpu_torch.bench` (device cuda, the
    default) exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "shasta_tpu_torch.bench", "--device", "cuda"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr
