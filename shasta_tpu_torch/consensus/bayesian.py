"""Bayesian repeat-count consensus caller.

Counterpart of the reference SimpleBayesianConsensusCaller
(reference: src/SimpleBayesianConsensusCaller.{hpp,cpp}): per MSA
column, pick the consensus base by plurality, then choose the true
repeat length y maximizing

    prior[AT|GC][y] + sum_observations c_x * log10 P(x | y, base)

over y in [0, max_output_runlength] (predictRunlength at
src/SimpleBayesianConsensusCaller.cpp:374-430). Observations are
factored per (strand, repeat) with counts; observed lengths above the
matrix bound are capped; by default only observations matching the
consensus base contribute (ignoreNonConsensusBaseRepeats, :136).

Model sources:
- the 9 packaged trained models in ``consensus/models/*.csv`` —
  extracted from the reference's own shipped model data: the 8
  built-in basecaller models (guppy-2.3.1-a ... guppy-5.0.7-b,
  bonito-0.3.1-a, r10-guppy-3.4.8-a) from the numeric tables in the
  builtin headers
  (reference: src/SimpleBayesianConsensusCaller-Builtin-*.hpp), plus
  ecoli-flipflop-k12 from conf/SimpleBayesianConsensusCaller-2.csv,
  re-serialized into the reference's own CSV model format.
  ``Bayesian:{N}`` numbered names (the reference's
  conf/SimpleBayesianConsensusCaller-{N}.csv family) resolve through
  ``_NUMBERED_ALIASES``;
- a CSV file in the reference's format (sections ">AT prior",
  ">GC prior", ">A likelihood" ... — conf/SimpleBayesianConsensusCaller-*.csv);
- a built-in parametric model ("default") with a geometric-tailed
  error profile, for use when no trained model is named.
  SHASTA_TORCH_BAYESIAN_MODEL_DIR adds a user directory searched before
  the packaged models.

The argmax over y for a whole batch of columns is one matrix product:
scores[y] = prior[y] + counts . L[base], one product per base when called
through ``repeat_counts_batch``.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional

import numpy as np

GAP = 4

_BASE_NAMES = "ACGT"


class BayesianModel:
    """priors: (2, n_y) log10; likelihood: (4, n_y, n_x) log10."""

    def __init__(self, name: str, priors: np.ndarray, likelihood: np.ndarray):
        self.name = name
        self.priors = priors
        self.likelihood = likelihood

    @property
    def max_output_runlength(self) -> int:
        return self.priors.shape[1] - 1

    @property
    def max_input_runlength(self) -> int:
        return self.likelihood.shape[2] - 1


def load_model_csv(path: str) -> BayesianModel:
    """Parse the reference's model CSV format."""
    sections: Dict[str, List[str]] = {}
    current: Optional[str] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                current = line[1:].strip()
                sections[current] = []
            elif current is not None:
                sections[current].append(line)

    def rows(name) -> np.ndarray:
        return np.array(
            [[float(x) for x in r.split(",") if x] for r in sections[name]]
        )

    at_prior = rows("AT prior")[0]
    gc_prior = rows("GC prior")[0]
    priors = np.stack([at_prior, gc_prior])
    like = np.stack([rows(f"{b} likelihood") for b in _BASE_NAMES])
    name = sections.get("Name", [os.path.basename(path)])[0]
    return BayesianModel(name, priors, like)


def parametric_model(
    max_len: int = 50, error: float = 0.12, decay: float = 0.55
) -> BayesianModel:
    """A smooth analytic stand-in for a basecaller-trained model:
    P(x | y) concentrates at x == y with geometric tails whose width
    grows with y (homopolymer undercall bias included)."""
    y = np.arange(max_len + 1)[:, None]
    x = np.arange(max_len + 1)[None, :]
    d = x - y
    # Asymmetric geometric tails: undercalls (d<0) slightly more likely.
    tail = np.where(d < 0, decay ** (np.abs(d) / (1 + 0.15 * y)), (decay * 0.8) ** (np.abs(d) / (1 + 0.1 * y)))
    p = np.where(d == 0, 1.0 - error, error * tail)
    p = p / p.sum(axis=1, keepdims=True)
    loglike = np.log10(np.maximum(p, 1e-12))
    # Priors: empirical run-length distribution ~ power law.
    prior = 1.0 / np.maximum(np.arange(max_len + 1), 1) ** 2.5
    prior[0] = 1e-9
    prior = prior / prior.sum()
    logprior = np.log10(prior)
    priors = np.stack([logprior, logprior])
    like = np.stack([loglike] * 4)
    return BayesianModel("parametric-default", priors, like)


_PACKAGED_MODEL_DIR = os.path.join(os.path.dirname(__file__), "models")

# The reference ships the same trained matrices twice: as built-in
# headers (src/SimpleBayesianConsensusCaller-Builtin-*.hpp) and as
# numbered conf CSVs (conf/SimpleBayesianConsensusCaller-{N}.csv).
# Verified value-identical pairings; N=2 (E. coli flipflop) exists
# only as a conf CSV and is packaged as ecoli-flipflop-k12.
_NUMBERED_ALIASES = {
    "2": "ecoli-flipflop-k12",
    "3": "guppy-2.3.1-a",
    "5": "guppy-3.0.5-a",
    "6": "guppy-3.4.4-a",
    "7": "guppy-3.6.0-a",
    "8": "r10-guppy-3.4.8-a",
    "9": "bonito-0.3.1-a",
    "10": "guppy-5.0.7-a",
    "11": "guppy-5.0.7-b",
}


def builtin_model_names() -> List[str]:
    """Names of the packaged trained models."""
    if not os.path.isdir(_PACKAGED_MODEL_DIR):
        return []
    return sorted(
        f[:-4] for f in os.listdir(_PACKAGED_MODEL_DIR) if f.endswith(".csv")
    )


def resolve_model(name: str) -> BayesianModel:
    """Name resolution: file path, $SHASTA_TORCH_BAYESIAN_MODEL_DIR/name.csv,
    a packaged trained model, or the parametric fallback."""
    if os.path.exists(name):
        return load_model_csv(name)
    name = _NUMBERED_ALIASES.get(name, name)
    model_dir = os.environ.get("SHASTA_TORCH_BAYESIAN_MODEL_DIR", "")
    for d in ([model_dir] if model_dir else []) + [_PACKAGED_MODEL_DIR]:
        p = os.path.join(d, f"{name}.csv")
        if os.path.exists(p):
            return load_model_csv(p)
        p = os.path.join(d, f"SimpleBayesianConsensusCaller-{name}.csv")
        if os.path.exists(p):
            return load_model_csv(p)
    if name not in ("default", "parametric"):
        warnings.warn(
            f"Bayesian model {name!r} not found; using the parametric "
            "default model (valid trained models: "
            f"{', '.join(builtin_model_names())})."
        )
    return parametric_model()


class BayesianConsensusCaller:
    name = "Bayesian"

    def __init__(self, model_name: str = "default"):
        self.model = resolve_model(model_name)
        self.ignore_non_consensus_base_repeats = True
        self.predict_gap_runlengths = False

    def __call__(self, bases: np.ndarray, repeats: np.ndarray):
        from shasta_tpu_torch.consensus.caller import most_frequent_base

        b = most_frequent_base(bases)
        if b == GAP and not self.predict_gap_runlengths:
            return GAP, 0
        return b, self.predict_runlength(bases, repeats, b)

    def predict_runlength(
        self, bases: np.ndarray, repeats: np.ndarray, base: int
    ) -> int:
        m = self.model
        if self.ignore_non_consensus_base_repeats and base != GAP:
            sel = bases == base
            obs = repeats[sel]
        else:
            obs = repeats[bases != GAP]
        if obs.shape[0] == 0:
            return 0
        obs = np.minimum(obs, m.max_input_runlength)
        counts = np.bincount(obs, minlength=m.max_input_runlength + 1).astype(
            np.float64
        )
        prior_idx = 0 if base in (0, 3) else 1  # A/T vs C/G
        scores = m.priors[prior_idx] + m.likelihood[min(base, 3)] @ counts
        return int(np.argmax(scores))

    def consensus_columns(self, base_m: np.ndarray, rep_m: np.ndarray):
        """Vectorized per-column consensus over an MSA matrix
        (n_rows, width). Equal to calling self(base_m[:, c],
        rep_m[:, c]) per column; returns (cons_base uint8 [width],
        cons_rep int32 [width]) with GAP consensus marked GAP/0."""
        m = self.model
        n_rows, width = base_m.shape
        if width == 0:
            return np.zeros(0, np.uint8), np.zeros(0, np.int32)
        cols = np.tile(np.arange(width, dtype=np.int64), n_rows)
        flat_b = base_m.ravel().astype(np.int64)
        bh = np.bincount(flat_b * width + cols, minlength=5 * width)
        bh = bh.reshape(5, width)
        cons_base = np.argmax(bh, axis=0).astype(np.uint8)

        max_in = m.max_input_runlength
        if self.ignore_non_consensus_base_repeats:
            sel = (base_m == cons_base[None, :]) & (
                cons_base[None, :] != GAP
            )
        else:
            sel = base_m != GAP
        midx = np.flatnonzero(sel.ravel())
        obs = np.minimum(rep_m.ravel().astype(np.int64)[midx], max_in)
        counts = np.bincount(
            cols[midx] * (max_in + 1) + obs,
            minlength=width * (max_in + 1),
        ).reshape(width, max_in + 1).astype(np.float64)

        cons_rep = np.zeros(width, np.int32)
        has_obs = counts.sum(axis=1) > 0
        for b in range(4):
            csel = np.flatnonzero((cons_base == b) & has_obs)
            if csel.shape[0] == 0:
                continue
            prior_idx = 0 if b in (0, 3) else 1
            scores = counts[csel] @ m.likelihood[b].T + m.priors[prior_idx][None, :]
            cons_rep[csel] = np.argmax(scores, axis=1).astype(np.int32)
        return cons_base, cons_rep

    def repeat_count(self, repeats: np.ndarray) -> int:
        """Fixed-base variant (vertex assembly)."""
        if repeats.shape[0] == 0:
            return 0
        return self.predict_runlength(
            np.zeros(repeats.shape[0], np.int64), repeats, 0
        )

    def repeat_counts_batch(
        self, count_matrix: np.ndarray, prior_idx: np.ndarray, base: np.ndarray
    ) -> np.ndarray:
        """Batched argmax: count_matrix (n, n_x) observation histograms,
        prior_idx (n,), base (n,). One matmul per base value."""
        m = self.model
        n = count_matrix.shape[0]
        out = np.zeros(n, dtype=np.int32)
        for b in range(4):
            sel = np.flatnonzero(base == b)
            if sel.shape[0] == 0:
                continue
            scores = count_matrix[sel] @ m.likelihood[b].T  # (k, n_y)
            scores += m.priors[prior_idx[sel]]
            out[sel] = np.argmax(scores, axis=1)
        return out
