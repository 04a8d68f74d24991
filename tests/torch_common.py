"""Shared pieces of the port's tests (numpy and torch only, so that the
tests that run on the card need neither jax nor shasta_tpu)."""

import contextlib
import hashlib
import io
import json
import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tier-1 runs several test workers on a few cores; one intra-op
    thread per worker keeps the plain DP's many small ops from
    oversubscribing them (OpenMP spin-waits made it 40x slower).
    Applies to each test module that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(seed, B=8, LA=128, LB=128, W=128, alpha=50):
    """Pairs cut from one random sequence with offsets inside the band
    (real matches), random substitutions, one empty pair, and bands
    partly or wholly outside the matrix."""
    rng = np.random.default_rng(seed)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LB), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    for t in range(B):
        g = rng.integers(0, alpha, LA + LB + 200).astype(np.int32)
        la = int(rng.integers(1, LA + 1))
        lb = int(rng.integers(1, LB + 1))
        sa = int(rng.integers(0, 100))
        sb = max(0, sa + int(rng.integers(-20, 20)))
        a[t, :la] = g[sa : sa + la]
        b[t, :lb] = g[sb : sb + lb]
        sub = rng.random(la) < 0.1
        a[t, :la][sub] = rng.integers(0, alpha, int(sub.sum()))
        a_len[t], b_len[t] = la, lb
        bm[t] = -W // 2 + int(rng.integers(-W // 4, W // 4 + 1))
    a_len[0] = 0  # empty pair
    bm[1] = -(LA + W) - 3  # band wholly left of the matrix
    bm[2] = LB + 1  # band wholly right of the matrix
    bm[3] = -(LA + W)  # band at the clamp limit
    return a, a_len, b, b_len, bm


def edge_batch(LA=128, W=128):
    """The batch of test_align_pallas.py::test_edge_cases_match_jnp_kernel
    (LA = LB): empty pairs, length-1 sequences, bands at both clamp
    limits, a full-length identical pair and padding rows."""
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


def gap_batch(LA=256, W=128, seed=11):
    """Pairs whose alignments carry long gaps, so that a traceback path
    crosses 32-lane chunks of the band both ways: b with an insertion of
    length L (a run of LEFT moves, walked back towards lane 0) and a
    with an insertion of length L (a run of UP moves, walked back
    towards lane W - 1), L in {40, 70}, the band placed so that the path
    starts near one end of it."""
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
        if t < B // 2:  # insertion in b: j - i grows by L
            a[t, :n], b[t, : n + L] = g, long_
            a_len[t], b_len[t] = n, n + L
            bm[t] = -(W // 8) - (t % 3)
        else:  # insertion in a: j - i falls by L
            a[t, : n + L], b[t, :n] = long_, g
            a_len[t], b_len[t] = n + L, n
            bm[t] = -L - (W // 8) + (t % 3)
    return a, a_len, b, b_len, bm


def mixed_batch(LA=128, W=128, B=13, seed=21):
    """Pairs of very different lengths side by side, as the waves kernel
    puts them in one warp: a_len cycles through 0, 1, 2, 17, LA // 2, LA
    and LA + 40 (clamped to LA rows), b_len within 5 of it, each pair a
    copy of one sequence with 10% substitutions and its band centred near
    the diagonal."""
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


def full_matrix_batch(LA, W, B=6, seed=5, LB=None, alpha=40, empty=False):
    """Phase-1-like pairs (ops/align.py, method 3's first phase): lengths
    uniform in [LA / 4, LA] (b up to LB), the full-matrix band j - i in
    [-la, lb] centred in W (band_min = -la - (W - la - lb - 1) // 2),
    b a shifted copy of a with 10 % substitutions; one pair of length 1,
    one with b_len = LB, and (empty=True) one with a_len 0."""
    LB = LA if LB is None else LB
    rng = np.random.default_rng(seed)
    a = np.full((B, LA), -1, np.int32)
    b = np.full((B, LB), -2, np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    bm = np.zeros(B, np.int32)
    for t in range(B):
        la = int(rng.integers(max(1, LA // 4), LA + 1))
        lb = int(rng.integers(max(1, LB // 4), LB + 1))
        if t == 1:
            la = lb = 1
        if t == 2:
            lb = LB
        g = rng.integers(0, alpha, la + lb + 8).astype(np.int32)
        s = int(rng.integers(0, 8))
        a[t, :la] = g[:la]
        b[t, :lb] = g[s : s + lb]
        hit = rng.random(lb) < 0.1
        b[t, :lb][hit] = rng.integers(0, alpha, int(hit.sum()))
        a_len[t], b_len[t] = la, lb
        bm[t] = -la - max(0, W - la - lb - 1) // 2
    if empty:
        a_len[3] = 0
    return a, a_len, b, b_len, bm


# tests/test_assembly_e2e.py:small_config as (section, key, value) overrides
# of the configuration defaults.
SMALL_CONF = [
    ("Reads", "minReadLength", "500"), ("Kmers", "k", "8"),
    ("Kmers", "probability", "0.1"), ("MinHash", "hashFraction", "0.05"),
    ("MinHash", "minHashIterationCount", "6"), ("MinHash", "maxBucketSize", "60"),
    ("Align", "minAlignedMarkerCount", "20"), ("Align", "maxSkip", "60"),
    ("Align", "maxDrift", "60"), ("Align", "maxTrim", "60"),
    ("ReadGraph", "maxAlignmentCount", "8"), ("MarkerGraph", "minCoverage", "3"),
]


def mode2_golden_config(cfg=None):
    """tests/test_reference_parity.py:_golden_run_mode2's configuration
    on the port's class: ``cfg`` (default: SMALL_CONF on the defaults)
    with mode 2, minEdgeCoverage 3, per strand 0 and bubble-removal
    component-size threshold 3."""
    from shasta_tpu_torch.pipeline.config import AssemblyConfig

    if cfg is None:
        cfg = AssemblyConfig()
        for section, key, value in SMALL_CONF:
            cfg.set(section, key, value)
    cfg.assembly.mode = 2
    cfg.marker_graph.min_edge_coverage = 3
    cfg.marker_graph.min_edge_coverage_per_strand = 0
    cfg.assembly.mode2_bubble_removal_component_size_threshold = 3
    return cfg


def write_mode2_reads(path):
    """_golden_run_mode2's reads, made with the port's utils/synth.py:
    two 15 kb haplotypes with a SNP every 700 bases, 90 + 90 reads of
    2.5 kb from both strands."""
    from shasta_tpu_torch.utils import synth

    rng = np.random.default_rng(4343)
    hap_a = synth.random_genome(15000, seed=4444)
    hap_b = hap_a.copy()
    for p in np.arange(350, 15000, 700):
        hap_b[p] = (hap_b[p] + 1 + rng.integers(0, 3)) % 4
    reads = synth.sample_reads(hap_a, 90, 2500, seed=4445, both_strands=True)
    reads += synth.sample_reads(hap_b, 90, 2500, seed=4446, both_strands=True)
    synth.write_fasta(path, reads)


def stage_hashes(run_dir, store_cls=None):
    """tests/test_reference_parity.py:_stage_hashes: sha256 over each
    array's name, dtype, shape and bytes, per stage manifest, read with
    ``store_cls`` (default: the port's RunStore)."""
    if store_cls is None:
        from shasta_tpu_torch.data.store import RunStore as store_cls

    store = store_cls(run_dir, create=False)
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


# Method 4's grouped route: (a length, b length, band width, pairs). The
# W classes 128, 512 and 2048, each at an LA where fwd_body gives the
# anti-diagonal body and at one where it gives the row-scan body; widths
# 300 and 1500 are centred inside their class.
GROUPED = [
    (100, 110, 97, 3), (120, 90, 300, 2), (400, 420, 300, 3),
    (400, 380, 1500, 2), (900, 950, 1500, 2), (1000, 990, 2048, 1),
]


def grouped_inputs(cases=GROUPED, seed=404):
    """Host rows for ``_grouped_run``: b a shifted copy of a with 10%
    substitutions, each band on the pair's diagonal, off centre by up to
    an eighth of its width."""
    rng = np.random.default_rng(seed)
    a_rows, b_rows, bmins, widths = [], [], [], []
    for la, lb, w, n in cases:
        for _ in range(n):
            g = rng.integers(0, 300, la + lb).astype(np.int32)
            shift = int(rng.integers(0, 30))
            a = g[:la].copy()
            b = g[shift : shift + lb].copy()
            hit = rng.random(lb) < 0.1
            b[hit] = rng.integers(0, 300, int(hit.sum()))
            a_rows.append(a)
            b_rows.append(b)
            bmins.append(-shift - w // 2 + int(rng.integers(-(w // 8), w // 8 + 1)))
            widths.append(w)
    return a_rows, b_rows, np.asarray(bmins, np.int64), np.asarray(widths, np.int64)


def wide_batch(LA=64, W=16400, B=2, seed=31):
    """Pairs in a band wider than 16384 lanes, whose live window (b of
    W + LA) passes what one block holds, so the row-scan body runs them
    on a thread-block cluster. b is long enough (LB = W + LA) that every
    lane of the band lies inside the matrix on some row. Each pair's a
    is a stretch of b with 10% substitutions, and b carries an insertion
    of L bases halfway along it, placed so that the path's lane jumps
    across a multiple of 16384 (a run of LEFT moves that the prefix max
    carries from one block of the cluster to the next). Odd pairs end on
    b's last column three rows before a's last row; the band starts at
    lane 0 or up to 2 lanes left of j - i = 0."""
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


def compact_batch(B, LA, keep="some", seed=61, big=False):
    """A fused (B, 16 + LA) int32 batch for match_compact and its CSR
    destinations. Each row's matches (columns 16 on) are a random share
    of its columns holding ascending ordinal1 values (-1 elsewhere);
    every third row has none. ``keep``: "some" keeps every other row,
    "all" every row, "none" no row. ``big``: values past 65,535, which
    only the uint32 output holds. Returns (fused, dst (B,) int64 with -1
    on rows not kept, the CSR's length)."""
    rng = np.random.default_rng(seed)
    fused = np.zeros((B, 16 + LA), np.int32)
    mj = np.full((B, LA), -1, np.int32)
    for t in range(B):
        if t % 3 == 2:
            continue
        cols = np.flatnonzero(rng.random(LA) < rng.uniform(0.05, 0.9))
        step = rng.integers(1, 3, cols.shape[0])
        mj[t, cols] = np.cumsum(step) + (70000 if big else 0)
    fused[:, 16:] = mj
    count = (mj >= 0).sum(axis=1)
    fused[:, 0] = count
    kept = {"some": np.arange(B) % 2 == 0, "all": np.ones(B, bool),
            "none": np.zeros(B, bool)}[keep]
    dst = np.full(B, -1, np.int64)
    # Kept rows' slots in reverse row order, so the CSR's order is not
    # the batch's.
    order = np.flatnonzero(kept)[::-1]
    offs = np.concatenate([[0], np.cumsum(count[order])])
    dst[order] = offs[:-1]
    return fused, dst, int(offs[-1])


def compact_reference(fused, dst, n, dtype):
    """match_compact's output as a numpy loop over the rows: ord0, ord1
    of ``dtype``, zero wherever no kept match lands."""
    ord0 = np.zeros(n, dtype)
    ord1 = np.zeros(n, dtype)
    for t in np.flatnonzero(dst >= 0):
        cols = np.flatnonzero(fused[t, 16:] >= 0)
        ord0[dst[t] : dst[t] + cols.shape[0]] = cols
        ord1[dst[t] : dst[t] + cols.shape[0]] = fused[t, 16 + cols]
    return ord0, ord1


def palindrome_reads(n=6):
    """The first ``n`` reads of the mode-0 golden input (a 25 kb genome,
    seed 4242; 130 reads of 3 kb from both strands, seed 4243), made
    with the port's utils/synth.py, and one palindromic read: 1.5 kb of
    the golden genome followed by its reverse complement."""
    from shasta_tpu_torch.data import bases as B
    from shasta_tpu_torch.utils import synth

    genome = synth.random_genome(25000, seed=4242)
    reads = synth.sample_reads(genome, 130, 3000, seed=4243, both_strands=True)[:n]
    half = genome[1000:2500]
    return reads + [np.concatenate([half, B.reverse_complement(half)])]


# ---------------------------------------------------------------------------
# The stage-driver scripts: scripts/ (the JAX package's) against
# shasta_tpu_torch/scripts/ (the port's), each run on its own copy of one
# run directory.
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPTS = os.path.join(ROOT, "scripts")
PORT_SCRIPTS = os.path.join(ROOT, "shasta_tpu_torch", "scripts")

# Files that hold times: the stage store's manifest (each stage's save
# time) and the performance log.
TIMED_FILES = {"manifest.json", "performance.log"}

# What a script may print that differs between two correct runs: times
# and rates, and the package's name.
_TIMES = re.compile(r"\d+(\.\d+)? M unions/s")
# write_output's summary keys that hold times and this process's memory.
_MEASURED = re.compile(r"Seconds$|^elapsed|^peakMemory|CpuUtilization$")


def _file_digest(path):
    """sha256 of a file; of write_output's summaries, with the package's
    name, times and memory taken out."""
    with open(path, "rb") as f:
        data = f.read()
    name = os.path.basename(path)
    if name == "AssemblySummary.json":
        summary = {k: v for k, v in json.loads(data).items() if not _MEASURED.search(k)}
        data = json.dumps(summary, sort_keys=True).encode()
    elif name.endswith(".html"):
        text = data.decode().replace("shasta_tpu_torch", "shasta_tpu")
        data = re.sub(
            r"<tr><th>(\w+)</th><td>[^<]*</td></tr>",
            lambda m: "" if _MEASURED.search(m.group(1)) else m.group(0), text,
        ).encode()
    return hashlib.sha256(data).hexdigest()


def script_state(root, store_cls=None):
    """What a script step leaves behind under ``root``: the stage hashes
    of each stage store under it, by run directory, and the _file_digest
    of every file but those named in TIMED_FILES, by path (both relative
    to ``root``)."""
    out = {"stages": {}, "files": {}}
    for dirpath, dirs, names in os.walk(root):
        dirs.sort()
        rel = os.path.relpath(dirpath, root).replace(os.sep, "/")
        if os.path.exists(os.path.join(dirpath, "Data", "manifest.json")):
            out["stages"][rel] = stage_hashes(dirpath, store_cls)
        for n in names:
            if n in TIMED_FILES:
                continue
            path = os.path.join(dirpath, n)
            key = n if rel == "." else f"{rel}/{n}"
            if os.path.islink(path):
                out["files"][key] = "-> " + os.path.relpath(os.readlink(path), root)
            else:
                out["files"][key] = _file_digest(path)
    return out


def _exit_code(e):
    return e.code if isinstance(e.code, int) else int(e.code is not None)


def jax_script(name, argv):
    """Run scripts/<name> (or the script at the absolute path ``name``)
    as ``python scripts/<name> *argv`` would, in this process; its exit
    code."""
    path = name if os.path.isabs(name) else os.path.join(JAX_SCRIPTS, name)
    old = sys.argv
    sys.argv = [path] + list(argv)
    try:
        runpy.run_path(path, run_name="__main__")
        return 0
    except SystemExit as e:
        return _exit_code(e)
    finally:
        sys.argv = old


def port_script(name, argv):
    """shasta_tpu_torch/scripts/<name>'s main(argv), in this process; its
    exit code."""
    if PORT_SCRIPTS not in sys.path:
        sys.path.insert(0, PORT_SCRIPTS)
    import _common

    try:
        return _common.load(name[: -len(".py")]).main(list(argv))
    except SystemExit as e:
        return _exit_code(e)


def run_steps(steps, root, runner, store_cls=None):
    """Run each step ({"script", "argv", "env"}; "{root}" in an argument
    stands for ``root``) with ``runner``, and return per step its exit
    code (or the exception it raised, with ``root`` as "<root>"), stdout,
    stderr and script_state(root) after it."""
    results = []
    for step in steps:
        argv = [a.replace("{root}", root) for a in step["argv"]]
        env = {k: v.replace("{root}", root) for k, v in step.get("env", {}).items()}
        old_env = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        out, err = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                try:
                    rc = runner(step["script"], argv)
                except Exception as e:  # recorded, and held to the other side
                    rc = f"{type(e).__name__}: {e}".replace(root, "<root>")
        finally:
            for k, v in old_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        results.append({
            "rc": 0 if rc is None else rc,
            "stdout": out.getvalue(), "stderr": err.getvalue(),
            "state": script_state(root, store_cls),
        })
    return results


_JAX_CHILD = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
from shasta_tpu.data.store import RunStore
from tests.torch_common import jax_script, run_steps
with open(sys.argv[3]) as f:
    steps = json.load(f)
with open(sys.argv[4], "w") as f:
    json.dump(run_steps(steps, sys.argv[2], jax_script, RunStore), f)
"""


def run_jax_steps(steps, root):
    """run_steps over the JAX package's scripts, in one child interpreter
    (the two directories' _common modules share a name)."""
    spec = os.path.join(os.path.dirname(root), os.path.basename(root) + "-steps.json")
    result = spec[: -len(".json")] + "-out.json"
    with open(spec, "w") as f:
        json.dump(steps, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_CHILD, JAX_SCRIPTS, root, spec, result],
        cwd=root, env=env, capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    with open(result) as f:
        return json.load(f)


def repaired_script(name, old, new, dest):
    """A copy of scripts/<name> in the directory ``dest`` with its one
    ``old`` text replaced by ``new`` (a fault repaired as the port repairs
    it); its path."""
    with open(os.path.join(JAX_SCRIPTS, name)) as f:
        text = f.read()
    assert text.count(old) == 1, (name, old)
    path = os.path.join(dest, name[: -len(".py")] + "-repaired.py")
    with open(path, "w") as f:
        f.write(text.replace(old, new))
    return path


def normalized(text, root):
    """A script's output with its root directory, the package's name and
    printed rates taken out."""
    text = text.replace(root, "<root>").replace("shasta_tpu_torch", "shasta_tpu")
    return _TIMES.sub("<rate>", text)


def sampled_reads(genome_len, reads, read_len, seeds):
    """A writer of a FASTA of ``reads`` reads of ``read_len`` bases from
    both strands of a random genome (``seeds``: the genome's and the
    reads'), made with the port's utils/synth.py."""
    from shasta_tpu_torch.utils import synth

    def write(path):
        genome = synth.random_genome(genome_len, seed=seeds[0])
        synth.write_fasta(
            path, synth.sample_reads(genome, reads, read_len, seed=seeds[1], both_strands=True)
        )

    return write


def small_run(root, write_reads, **overrides):
    """The port's whole assemble run on the CPU, under SMALL_CONF and
    ``overrides`` ({"Section.key": value}), on the reads
    ``write_reads(path)`` writes, into ``root/base/run``; returns that run
    directory."""
    from shasta_tpu_torch.pipeline.assemble import run_assembly
    from shasta_tpu_torch.pipeline.config import AssemblyConfig

    base = os.path.join(root, "base")
    os.makedirs(base)
    fasta = os.path.join(base, "reads.fasta")
    write_reads(fasta)
    cfg = AssemblyConfig()
    for section, key, value in SMALL_CONF:
        cfg.set(section, key, value)
    for name, value in overrides.items():
        cfg.set(*name.split(".", 1), str(value))
    run_dir = os.path.join(base, "run")
    with contextlib.redirect_stdout(io.StringIO()):
        run_assembly([fasta], run_dir, cfg, device="cpu")
    return run_dir


def twin_runs(run_dir, root):
    """Two copies of ``run_dir``, as ``root/jax/run`` and ``root/port/run``;
    returns the two roots."""
    import shutil

    roots = []
    for side in ("jax", "port"):
        r = os.path.join(root, side)
        shutil.copytree(run_dir, os.path.join(r, "run"), symlinks=True)
        roots.append(r)
    return roots


def assert_same_step(ref, got, ref_root, got_root, expect=None, rc=0):
    """One script step of the JAX package (``ref``) and of the port
    (``got``), from run_steps: the exit code ``rc`` on both, equal
    normalized stdout (holding ``expect``), equal stage hashes and equal
    files."""
    assert (ref["rc"], got["rc"]) == (rc, rc), (
        ref["rc"], got["rc"], ref["stderr"][-2000:], got["stderr"][-2000:]
    )
    out = normalized(got["stdout"], got_root)
    assert out == normalized(ref["stdout"], ref_root)
    if expect is not None:
        assert expect in out, out
    for kind in ("stages", "files"):
        a, b = ref["state"][kind], got["state"][kind]
        differ = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        assert not differ, (kind, differ)
