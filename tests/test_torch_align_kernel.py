"""The port's banded DP (shasta_tpu_torch.ops.align_kernel) against the
JAX package's kernel and oracle.

Every comparison is exact integer equality: the DP is int32 arithmetic
with a fixed tie-break, so the port must reproduce the reference bit for
bit. On the CPU the port runs its plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode (the monkeypatch of
tests/test_align_pallas.py) or its jnp oracle.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import shasta_tpu.ops.align as A
import shasta_tpu.ops.align_pallas as AP
from shasta_tpu_torch.ops import align_kernel as K
from tests.torch_common import make_batch, one_torch_thread, wide_batch  # noqa: F401

KW = dict(match=6, mismatch=-1, gap=-1)


@pytest.fixture
def interpret_mode(monkeypatch):
    """The JAX kernel in Pallas interpret mode, with its int16 transfer
    packing off so that it returns int32 like the port."""
    monkeypatch.setattr(
        AP.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    monkeypatch.setenv("SHASTA_TPU_INT16", "0")
    AP.banded_align_pairs.clear_cache()
    yield
    AP.banded_align_pairs.clear_cache()


def port(a, a_len, b, b_len, bm, **kw):
    args = [torch.from_numpy(np.asarray(x)) for x in (a, a_len, b, b_len, bm)]
    return K.banded_align_pairs(*args, **kw, **KW).numpy()


def jax_kernel(a, a_len, b, b_len, bm, **kw):
    args = [jnp.asarray(x) for x in (a, a_len, b, b_len, bm)]
    return np.asarray(AP.banded_align_pairs(*args, **kw, **KW))


@pytest.mark.parametrize(
    "LA,W,force_chunked",
    [(128, 128, False), (128, 288, False), (256, 128, True)],
    ids=["monolithic-128", "monolithic-W288", "chunked-256"],
)
def test_plain_matches_pallas_interpret(interpret_mode, LA, W, force_chunked):
    """Exact equality of the whole fused (B, 16 + LA) output with the
    JAX kernel on its monolithic and chunked routes, both int32."""
    a, a_len, b, b_len, bm = make_batch(LA + W, LA=LA, LB=LA, W=W)
    got = port(a, a_len, b, b_len, bm, LA=LA, LB=LA, W=W)
    ref = jax_kernel(
        a, a_len, b, b_len, bm, LA=LA, LB=LA, W=W, force_chunked=force_chunked
    )
    assert got.dtype == np.int32 and got.shape == (8, 16 + LA)
    assert ref.dtype == np.int32 and np.array_equal(got, ref)
    assert (got[:, 0] > 0).sum() >= 3  # the batch has real alignments


@pytest.mark.parametrize(
    "seed,LA", [(0, 128), (1, 128), (2, 17), (3, 1)], ids=["0", "1", "LA17", "LA1"]
)
def test_plain_matches_jnp_oracle(seed, LA):
    """The matched pairs and best score equal the jnp oracle
    (banded_forward + traceback), exactly; LA 17 and 1 end inside a
    16-row word of the plain version's dirs."""
    W = 128
    assert_matches_jnp_oracle(*make_batch(seed, LA=LA, LB=LA, W=W), LA=LA, LB=LA, W=W)


@pytest.mark.parametrize("W", [16400, 20000])
def test_plain_matches_jnp_oracle_past_16384(W):
    """Bands wider than 16384 lanes, which the card runs on thread-block
    clusters (ROADMAP.md fault 2): the plain version equals the jnp
    oracle on paths that cross lane 16384 by a run of LEFT moves."""
    LA = 64
    a, a_len, b, b_len, bm = wide_batch(LA, W, B=2)
    fused = assert_matches_jnp_oracle(a, a_len, b, b_len, bm, LA=LA, LB=b.shape[1], W=W)
    for t in range(2):
        o0 = np.flatnonzero(fused[t, 16:] >= 0)
        lanes = fused[t, 16 + o0] - o0 - bm[t]  # the matches' band lanes
        assert lanes.min() < 16384 < lanes.max(), t


def assert_matches_jnp_oracle(a, a_len, b, b_len, bm, *, LA, LB, W):
    """The port's fused output against the jnp oracle on the wrapper's
    clamped inputs: each pair's matched ordinals, count, best score and
    metrics equal. Returns the fused output."""
    fused = port(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W)
    leftpad = LA + W
    ok = (bm >= -leftpad) & (bm <= LB)
    al = np.where(ok, a_len, 0).astype(np.int32)
    bmc = np.clip(bm, -leftpad, LB).astype(np.int32)
    dirs, bi, bd, bv = A.banded_forward(a, al, b, b_len, bmc, W=W, **KW)
    m0r, m1r = A.traceback(dirs, a, b, bmc, bi, bd, n_steps=LA + LB)
    m0r, m1r, bv = map(np.asarray, (m0r, m1r, bv))
    for t in range(a.shape[0]):
        o0 = np.flatnonzero(fused[t, 16:] >= 0)
        o1 = fused[t, 16 + o0]
        rr0 = m0r[m0r[:, t] >= 0, t][::-1]
        rr1 = m1r[m1r[:, t] >= 0, t][::-1]
        assert np.array_equal(o0, rr0) and np.array_equal(o1, rr1), t
        assert fused[t, 0] == o0.shape[0]
        assert fused[t, 9] == bv[t], t
        if o0.shape[0]:
            ms, md, omin, omax = A._metrics_from_ordinals(
                o0.astype(np.uint32), o1.astype(np.uint32)
            )
            assert list(fused[t, 1:9]) == [
                o0[0], o0[-1], o1[0], o1[-1], omin, omax, ms, md
            ], t
    return fused


@pytest.mark.parametrize("waves", [2, 4])
@pytest.mark.parametrize(
    "seed,W", [(0, 128), (3, 128), (5, 512)], ids=["seed0", "seed3", "W512"]
)
def test_plain_matches_pallas_waves_interpret(
    interpret_mode, monkeypatch, seed, W, waves
):
    """The JAX package's _kernel_waves (interpret mode) on the batches of
    test_align_pallas.py::test_waves_kernel_matches_default equals the
    port's output with the same waves, exactly; a spy shows the JAX run
    took the waves kernel. (SHASTA_TPU_BB=32 only narrows the JAX
    kernel's pair blocks, so the padded batch is smaller.)"""
    from tests.test_align_pallas import make_batch as pallas_batch

    monkeypatch.setenv("SHASTA_TPU_BB", "32")
    taken = []
    real = AP._kernel_waves

    def spy(*args, **kw):
        taken.append(kw["waves"])
        return real(*args, **kw)

    monkeypatch.setattr(AP, "_kernel_waves", spy)
    LA = LB = 128
    a, a_len, b, b_len, bm = pallas_batch(seed, B=12, LA=LA, LB=LB, W=W)
    got = port(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W, waves=waves)
    ref = jax_kernel(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W, waves=waves)
    assert taken and set(taken) == {waves}
    assert ref.dtype == np.int32 and np.array_equal(got, ref)
    assert (got[:, 0] > 0).sum() >= 6  # the batch has real alignments


def test_resolve_waves_reads_env_each_call(monkeypatch):
    """SHASTA_TORCH_WAVES is read on every call (unlike the JAX package's
    SHASTA_TPU_WAVES, baked in at first trace); 1, 2 and 4 are the
    allowed values, and banded_align_pairs rejects any other."""
    monkeypatch.delenv("SHASTA_TORCH_WAVES", raising=False)
    assert K.resolve_waves() == 1
    for w in ("2", "4", "1"):
        monkeypatch.setenv("SHASTA_TORCH_WAVES", w)
        assert K.resolve_waves() == int(w)
    assert K.resolve_waves(4) == 4
    monkeypatch.setenv("SHASTA_TORCH_WAVES", "3")
    with pytest.raises(ValueError, match="1, 2 or 4"):
        K.resolve_waves()
    with pytest.raises(ValueError, match="1, 2 or 4"):
        K.resolve_waves(8)
    a, a_len, b, b_len, bm = make_batch(0, B=4, LA=16, LB=16, W=16)
    with pytest.raises(ValueError, match="1, 2 or 4"):
        port(a, a_len, b, b_len, bm, LA=16, LB=16, W=16)


def test_edge_cases_match_pallas_interpret(interpret_mode):
    """The batch of test_align_pallas.py::test_edge_cases_match_jnp_kernel:
    empty pairs, length-1 sequences, bands at both clamp limits, a
    full-length identical pair and padding rows; exact equality."""
    B, LA, LB, W = 8, 128, 128, 128
    rng = np.random.default_rng(9)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LB), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    g = rng.integers(0, 30, 300).astype(np.int32)
    b[0, :50] = g[:50]; b_len[0] = 50
    a[1, :50] = g[:50]; a_len[1] = 50
    a[2, 0] = 7; b[2, 0] = 7; a_len[2] = 1; b_len[2] = 1
    a[3, :60] = g[:60]; b[3, :60] = g[:60]
    a_len[3] = 60; b_len[3] = 60; bm[3] = -(LA + W)
    a[4, :60] = g[:60]; b[4, :60] = g[:60]
    a_len[4] = 60; b_len[4] = 60; bm[4] = LB
    a[5] = g[:LA]; b[5] = g[:LA]; a_len[5] = LA; b_len[5] = LB
    got = port(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W)
    ref = jax_kernel(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W)
    assert ref.dtype == np.int32 and np.array_equal(got, ref)
    for t in (0, 1, 3, 4, 6, 7):
        assert got[t, 0] == 0, t
    assert got[2, 0] == 1 and got[2, 16] == 0
    assert got[5, 0] == LA
    assert np.array_equal(got[5, 16 : 16 + LA], np.arange(LA))


def test_metrics_exact_past_row_32768():
    """skip/drift at rows >= 32768 (the 65536 length class) equal the
    host metric definition. The JAX package's packed (row << 16) key
    overflows int32 there and reports a wrong max_skip (ROADMAP.md,
    Faults); the port does not copy that."""
    LA = 65536
    mj = np.full((1, LA), -1, np.int32)
    rows = np.array([32760, 32768, 32769, 32770])
    mj[0, rows] = rows + 5
    host = A._metrics_from_ordinals(
        rows.astype(np.uint32), (rows + 5).astype(np.uint32)
    )
    met = K.metrics_from_mj(torch.from_numpy(mj), torch.zeros(1, dtype=torch.int32))
    met = met.numpy()[0]
    assert (met[7], met[8], met[5], met[6]) == host
    assert list(met[:5]) == [4, 32760, 32770, 32765, 32775]
    jax_met = np.asarray(AP._metrics_from_mj(jnp.asarray(mj.T), jnp.zeros(1, jnp.int32), LA))
    # The reference's fault, pinned: rows >= 32768 pair with the match
    # at row 32760, so it reports max_skip 10 where the path has 8.
    assert host[0] == 8 and jax_met[0, 7] == 10


def test_dirs_budget_chunks_give_same_output(monkeypatch):
    """Splitting a batch across launches under a smaller dirs budget
    leaves the output unchanged (exact integer equality)."""
    LA = LB = W = 128
    a, a_len, b, b_len, bm = make_batch(4, B=8, LA=LA, LB=LB, W=W)
    whole = port(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W)
    assert K.dirs_chunk_pairs(LA, W) >= 8
    monkeypatch.setattr(K, "_DIRS_BYTES", 0)
    assert K.dirs_chunk_pairs(LA, W) == 1
    split = port(a, a_len, b, b_len, bm, LA=LA, LB=LB, W=W)
    assert np.array_equal(whole, split)


def test_import_needs_no_nvcc_or_triton():
    """Importing the kernel module builds nothing and imports no triton:
    the kernels build at their first CUDA launch."""
    code = (
        "import sys\n"
        "from shasta_tpu_torch.ops import align_kernel as K\n"
        "assert K._lib is None\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_build_takes_every_source(tmp_path, monkeypatch):
    """build_kernels compiles every csrc/*.cu (one nvcc each, for
    sm_90a) and links their objects, and rebuilds when any *.cu or
    *.cuh is newer than the library: checked on the command lines and
    file times, without calling nvcc."""
    cu, cuh = K.kernel_sources()
    assert [os.path.basename(c) for c in cu] == [
        "banded_align.cu", "banded_fwd_diag.cu", "banded_tb.cu", "int32_peak.cu",
        "match_compact.cu",
    ]
    assert [os.path.basename(h) for h in cuh] == ["banded_common.cuh"]
    compiles, link = K.build_commands("nvcc", str(tmp_path / "lib.so"))
    assert [c[-1] for c in compiles] == cu
    for c in compiles:
        assert "arch=compute_90a,code=sm_90a" in c and "-c" in c
    assert "-shared" in link and link[-len(cu):] == [c[-2] for c in compiles]

    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("k.cu", "h.cuh"):
        (src / name).write_text("")
        os.utime(src / name, (1000, 1000))
    monkeypatch.setattr(K, "_CSRC_DIR", str(src))
    so = tmp_path / "lib.so"
    assert K.library_stale(str(so))  # not built yet
    so.write_text("")
    os.utime(so, (2000, 2000))
    assert not K.library_stale(str(so))
    os.utime(src / "h.cuh", (3000, 3000))  # a header changed
    assert K.library_stale(str(so))


@pytest.mark.parametrize(
    "LA,W,body",
    [
        (4096, 128, "diag"), (64, 128, "diag"), (512, 512, "diag"),
        (1024, 2048, "diag"), (128, 512, "rows"), (512, 2048, "rows"),
        (1, 128, "rows"), (4096, 2049, "diag"), (8192, 8192, "rows"),
    ],
)
def test_forward_body_by_la_and_width(LA, W, body):
    """banded_fwd runs the anti-diagonal body where its ramp of W / 2
    pair steps is at most the launch's LA and W <= DIAG_MAX_W (4096, the
    body's limit), and the row-scan body elsewhere."""
    assert K.fwd_body(LA, W) == body


@pytest.mark.parametrize(
    "LA,W", [(4096, 128), (128, 128), (64, 128), (512, 512), (1024, 2048),
             (128, 512), (512, 2048), (1, 128), (4096, 2049)],
)
@pytest.mark.parametrize("waves", [1, 2, 4])
def test_forward_kernel_route(LA, W, waves):
    """banded_align_pairs launches banded_fwd_waves exactly where waves > 1,
    fwd_body gives the anti-diagonal body and W <= WAVES_MAX_W (2048),
    banded_fwd elsewhere."""
    waves_shape = K.fwd_body(LA, W) == "diag" and W <= K.WAVES_MAX_W
    want = "banded_fwd_waves" if waves > 1 and waves_shape else "banded_fwd"
    assert K.fwd_kernel(LA, W, waves) == want


@pytest.mark.parametrize("LA,W", [(128, 128), (64, 128), (32, 128), (16, 33)])
def test_banded_align_pairs_takes_the_route(monkeypatch, LA, W):
    """A spy on both forward wrappers (each then runs the plain version
    on the CPU tensors): banded_align_pairs(waves=2) calls
    banded_fwd_waves with waves 2 where fwd_kernel says so and banded_fwd
    elsewhere, and the fused output equals waves 1's."""
    calls = []

    def spy(name):
        def run(*args, **kw):
            calls.append((name, kw.pop("waves", None)))
            return K.banded_fwd_plain(*args, **kw)
        return run

    monkeypatch.setattr(K, "banded_fwd", spy("banded_fwd"))
    monkeypatch.setattr(K, "banded_fwd_waves", spy("banded_fwd_waves"))
    a, a_len, b, b_len, bm = make_batch(LA + W, B=5, LA=LA, LB=LA, W=W)
    got = port(a, a_len, b, b_len, bm, LA=LA, LB=LA, W=W, waves=2)
    want = K.fwd_kernel(LA, W, 2)
    assert calls == [(want, 2 if want == "banded_fwd_waves" else None)]
    calls.clear()
    assert np.array_equal(got, port(a, a_len, b, b_len, bm, LA=LA, LB=LA, W=W, waves=1))
    assert calls == [("banded_fwd", None)]


def test_banded_fwd_waves_raises_outside_its_region():
    """banded_fwd_waves refuses a shape the anti-diagonal body does not
    take (W > 2 LA, W > DIAG_MAX_W) and waves other than 2 and 4, on
    every device; inside the region it equals banded_fwd_plain on the
    CPU."""
    kw = dict(LB=128, **KW)
    a, a_len, b, b_len, bm = (
        torch.from_numpy(x) for x in make_batch(5, B=5, LA=128, LB=128, W=128)
    )
    args = K.prepare_inputs(a, a_len, b, b_len, bm, LA=128, LB=128, W=128)
    for LA, W, waves in ((128, 512, 2), (64, 129, 4), (4096, 4096, 2), (128, 128, 3)):
        with pytest.raises(ValueError, match="banded_fwd_waves takes"):
            K.banded_fwd_waves(*args, LA=LA, W=W, waves=waves, **kw)
    for waves in (2, 4):
        got = K.banded_fwd_waves(*args, LA=128, W=128, waves=waves, **kw)
        ref = K.banded_fwd_plain(*args, LA=128, W=128, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, ref))


def test_cuda_device_without_card_raises(tmp_path):
    """device='cuda' with no card raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    from shasta_tpu_torch.pipeline.assemble import Assembler

    with pytest.raises(RuntimeError, match="no CUDA device"):
        K.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Assembler(str(tmp_path / "run"), device="cuda")
    assert K.resolve_device("cpu").type == "cpu"
