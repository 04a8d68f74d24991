"""The port's consensus callers and MSA against the JAX package's.

Every input is made from a seed with numpy and handed to both; every
comparison is exact (the callers are integer argmaxes over the same
float64 tables, the MSA is the same native partial-order alignment).
"""

import os
import warnings

import numpy as np
import pytest

from shasta_tpu.consensus import bayesian as ref_bayesian
from shasta_tpu.consensus import caller as ref_caller
from shasta_tpu import native as ref_native
from shasta_tpu.consensus import msa as ref_msa
from shasta_tpu_torch.consensus import bayesian, caller, msa

MODEL_NAMES = [
    "bonito-0.3.1-a", "ecoli-flipflop-k12", "guppy-2.3.1-a", "guppy-3.0.5-a",
    "guppy-3.4.4-a", "guppy-3.6.0-a", "guppy-5.0.7-a", "guppy-5.0.7-b",
    "r10-guppy-3.4.8-a",
]
PORT_MODELS = os.path.join(
    os.path.dirname(os.path.abspath(bayesian.__file__)), "models"
)


def columns(seed, n=200, depth=12):
    """Seeded coverage columns: a dominant base with noise and gaps,
    repeat counts around a true length (gaps carry 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = int(rng.integers(1, depth + 1))
        true_b = int(rng.integers(0, 4))
        bases = np.where(rng.random(d) < 0.7, true_b, rng.integers(0, 5, d))
        reps = np.clip(rng.integers(1, 5) + rng.integers(-1, 2, d), 1, 60)
        reps = np.where(bases == 4, 0, reps)
        out.append((bases.astype(np.int64), reps.astype(np.int64)))
    return out


@pytest.mark.parametrize("spec", ["Modal", "Median", "Bayesian:guppy-5.0.7-b"])
def test_caller_equals_reference(spec):
    """Per-column calls and fixed-base repeat counts equal the JAX
    package's, column by column."""
    port = caller.get_consensus_caller(spec)
    ref = ref_caller.get_consensus_caller(spec)
    assert type(port).__name__ == type(ref).__name__
    for bases, reps in columns(11):
        assert port(bases, reps) == ref(bases, reps)
        nz = reps[bases != 4]
        assert port.repeat_count(nz) == ref.repeat_count(nz)


def test_batched_calls_equal_reference():
    """The vectorized paths the assembly graph uses: the Bayesian MSA
    columns and batched argmax, and the Modal repeat-count batch."""
    rng = np.random.default_rng(5)
    port = caller.get_consensus_caller("Bayesian:guppy-5.0.7-b")
    ref = ref_caller.get_consensus_caller("Bayesian:guppy-5.0.7-b")
    base_m = np.where(rng.random((9, 40)) < 0.8, rng.integers(0, 4, 40), 4)
    rep_m = np.where(base_m == 4, 0, rng.integers(1, 8, (9, 40)))
    for a, b in zip(port.consensus_columns(base_m, rep_m),
                    ref.consensus_columns(base_m, rep_m)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    n_x = port.model.max_input_runlength + 1
    counts = rng.integers(0, 5, (64, n_x)).astype(np.float64)
    prior_idx = rng.integers(0, 2, 64)
    base = rng.integers(0, 4, 64)
    assert np.array_equal(
        port.repeat_counts_batch(counts, prior_idx, base),
        ref.repeat_counts_batch(counts, prior_idx, base),
    )
    reps = np.where(rng.random((50, 7)) < 0.8, rng.integers(1, 9, (50, 7)), -1)
    assert np.array_equal(
        caller.ModalConsensusCaller().repeat_counts_batch(reps),
        ref_caller.ModalConsensusCaller().repeat_counts_batch(reps),
    )


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_bayesian_model_loads_from_port_directory(name, monkeypatch):
    """Each of the 9 packaged models resolves, with no fallback warning,
    from the port's own consensus/models/ and holds the JAX package's
    tables exactly."""
    monkeypatch.delenv("SHASTA_TORCH_BAYESIAN_MODEL_DIR", raising=False)
    assert os.path.samefile(bayesian._PACKAGED_MODEL_DIR, PORT_MODELS)
    assert os.path.exists(os.path.join(PORT_MODELS, f"{name}.csv"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port = bayesian.resolve_model(name)
    ref = ref_bayesian.resolve_model(name)
    assert np.array_equal(port.priors, ref.priors)
    assert np.array_equal(port.likelihood, ref.likelihood)
    assert sorted(bayesian.builtin_model_names()) == MODEL_NAMES


def test_bayesian_model_dir_env_is_the_ports(tmp_path, monkeypatch):
    """SHASTA_TORCH_BAYESIAN_MODEL_DIR is searched before the packaged
    models; the JAX package's variable is not read."""
    src = os.path.join(PORT_MODELS, "guppy-2.3.1-a.csv")
    with open(src) as f:
        text = f.read()
    (tmp_path / "guppy-5.0.7-b.csv").write_text(text)
    monkeypatch.setenv("SHASTA_TPU_BAYESIAN_MODEL_DIR", str(tmp_path))
    default = bayesian.resolve_model("guppy-5.0.7-b")
    assert np.array_equal(
        default.likelihood, bayesian.load_model_csv(
            os.path.join(PORT_MODELS, "guppy-5.0.7-b.csv")
        ).likelihood,
    )
    monkeypatch.setenv("SHASTA_TORCH_BAYESIAN_MODEL_DIR", str(tmp_path))
    override = bayesian.resolve_model("guppy-5.0.7-b")
    assert np.array_equal(override.likelihood, bayesian.load_model_csv(src).likelihood)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_poa_msa_equals_reference(seed):
    """poa_msa through the port's native library: the aligned rows are
    equal to the JAX package's, for variants of one sequence ordered by
    frequency."""
    rng = np.random.default_rng(seed)
    root = rng.integers(0, 4, int(rng.integers(5, 40))).astype(np.uint8)
    seqs = []
    for _ in range(int(rng.integers(2, 7))):
        s = root.copy()
        for _ in range(int(rng.integers(0, 4))):
            pos = int(rng.integers(0, s.shape[0]))
            op = int(rng.integers(0, 3))
            if op == 0:
                s[pos] = rng.integers(0, 4)
            elif op == 1:
                s = np.insert(s, pos, rng.integers(0, 4)).astype(np.uint8)
            elif s.shape[0] > 1:
                s = np.delete(s, pos)
        seqs.append(s)
    got = msa.poa_msa(seqs)
    # The JAX package still falls back to a center-star MSA when its own
    # native build fails: name that side if it does.
    assert ref_native.available(), "the JAX package's native library did not load"
    ref = ref_msa.poa_msa(seqs)
    assert len(got) == len(ref) == len(seqs)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    assert len({g.shape[0] for g in got}) == 1
