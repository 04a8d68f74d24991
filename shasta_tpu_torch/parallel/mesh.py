"""Multi-device sharding of the pipeline's hot stages on torch.distributed.

Counterpart of ``shasta_tpu/parallel/mesh.py``. The reference scales
with a single-node thread pool over shared memory (reference:
src/MultithreadedObject.hpp:33-99). The JAX package shards over a
``jax.sharding.Mesh`` with ``shard_map`` collectives; the port's mesh is
a ``torch.distributed`` world with one rank per device, every rank
running the whole pipeline (SPMD):

- candidate pairs are data-parallel over the ranks: rank r aligns a
  contiguous 1/D of each batch (padded to a multiple of D with empty
  pairs) and the results are all-gathered;
- LowHash bucket entries are routed to their owner rank (bucket id
  modulo D) with ``all_to_all_single`` (reference's shared-memory bucket
  fill, src/LowHash0.cpp:169-182);
- the marker-graph union-find runs min-hooking rounds edge-parallel with
  an all-reduce MIN, then pointer jumping on the replicated labels
  (reference's lock-free CAS DSU, src/dset64-gccAtomic.hpp).

Every sharded function returns the full result on every rank, as the
JAX package's ``fetch_tree(out) if multiprocess()`` does, so the host
passes that follow stay replicated and in lockstep.

Backends. A mesh carries its backend: "nccl" runs the collectives on
the rank's CUDA device (one rank per card); "gloo" runs them on host
tensors, which is how ranks on the CPU, and ranks that share one card,
communicate (NCCL refuses two ranks of one communicator on one GPU). A
gloo rank on a card keeps its tensors and kernels there and copies each
collective's payload to the host and back. Nothing switches backend or
device by itself.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from shasta_tpu_torch.ops import align_kernel as AK

_M32 = 0xFFFFFFFF


def share_rows(n: int, size: int) -> int:
    """Rows per rank when ``n`` items are dealt out over ``size`` ranks:
    ceil(n / size). With :func:`rank_share`, the port's one sharding
    rule."""
    return -(-n // size)


def rank_share(n: int, size: int, rank: int) -> slice:
    """Rank ``rank``'s contiguous [start, stop) of ``n`` items dealt out
    :func:`share_rows` to a rank (the last shares may be short or
    empty)."""
    per = share_rows(n, size)
    return slice(min(rank * per, n), min((rank + 1) * per, n))


def device_key(device: torch.device) -> str:
    """What names a device across the ranks of a host: a card's UUID
    (launchers that give each rank its own ``CUDA_VISIBLE_DEVICES`` show
    every rank its card as ``cuda:0``), else the device's name."""
    if device.type == "cuda":
        return str(torch.cuda.get_device_properties(device).uuid)
    return str(device)


class Mesh:
    """One rank's view of a 1-D device mesh: the process group, this rank
    and the world size, the backend, and this rank's ``torch.device``.

    ``ranks_per_device`` counts the ranks of the world on this rank's
    device (the same host and :func:`device_key`): ranks that share a
    card split its memory budgets by it. ``seconds`` and ``calls`` hold
    the time and count of each kind of collective (``all_to_all``,
    ``all_reduce_min``, ``all_reduce_sum``, ``all_gather``). Under gloo a
    span is host wall time from a device synchronize (the payload's copy
    to the host waits for the queued kernels anyway), so it holds the
    exchange alone with its host copies. Under NCCL the host does not
    wait: a span is a pair of CUDA events on the current stream, read
    (with one synchronize) when ``seconds`` is."""

    def __init__(self, group, backend: str, device: torch.device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = backend
        self.device = device
        self.comm_device = device if backend == "nccl" else torch.device("cpu")
        self._host_s = {}
        self._events = {}
        self.calls = {}
        peers = [None] * self.size
        dist.all_gather_object(peers, (socket.gethostname(), device_key(device)), group=group)
        self.ranks_per_device = peers.count(peers[self.rank])

    @property
    def seconds(self) -> dict:
        """Seconds spent in each kind of collective so far."""
        out = dict(self._host_s)
        if self._events:
            torch.cuda.synchronize(self.device)
            for kind, spans in self._events.items():
                out[kind] = out.get(kind, 0.0) + sum(
                    e0.elapsed_time(e1) for e0, e1 in spans
                ) / 1e3
        return out

    def __repr__(self) -> str:
        return (
            f"Mesh(rank={self.rank}, size={self.size}, backend={self.backend!r}, "
            f"device={str(self.device)!r})"
        )

    # ----- collectives (every rank calls each one at the same point) -----

    def _timed(self, kind: str, fn):
        self.calls[kind] = self.calls.get(kind, 0) + 1
        if self.backend == "nccl":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn()
            e1.record()
            self._events.setdefault(kind, []).append((e0, e1))
            return out
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._host_s[kind] = self._host_s.get(kind, 0.0) + time.perf_counter() - t0
        return out

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """Elementwise ``op`` ("min" or "sum") of every rank's ``t``; a
        new tensor on ``t``'s device."""
        red = {"min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM}[op]

        def run():
            x = t.to(self.comm_device, copy=True)
            dist.all_reduce(x, op=red, group=self.group)
            return x.to(t.device)

        return self._timed(f"all_reduce_{op}", run)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on every rank) concatenated
        along dim 0 in rank order, on ``t``'s device."""

        def run():
            x = t.contiguous().to(self.comm_device)
            out = torch.empty(
                (self.size * x.shape[0],) + tuple(x.shape[1:]),
                dtype=x.dtype, device=self.comm_device,
            )
            dist.all_gather_into_tensor(out, x, group=self.group)
            return out.to(t.device)

        return self._timed("all_gather", run)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of shape (D, ...): row d goes to rank d. Returns (D, ...)
        whose row s came from rank s, on ``t``'s device."""

        def run():
            x = t.contiguous().to(self.comm_device)
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=self.group)
            return out.to(t.device)

        return self._timed("all_to_all", run)

    def share(self, n: int) -> slice:
        """This rank's :func:`rank_share` of ``n`` items."""
        return rank_share(n, self.size, self.rank)

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The ``n`` rows that :meth:`share` dealt out, brought back on
        every rank from each rank's ``local`` rows. Shares are padded to
        ceil(n / D) rows for the gather; every share before the last
        non-empty one is full, so the first ``n`` gathered rows are the
        items in order."""
        pad = share_rows(n, self.size) - local.shape[0]
        if pad:
            local = torch.cat([local, local.new_zeros((pad,) + tuple(local.shape[1:]))])
        return self.all_gather(local)[:n]

    def gather_host(self, arr: np.ndarray) -> np.ndarray:
        """Every rank's host array (any row count, the same dtype and row
        shape) concatenated row-wise in rank order."""
        return self._timed(
            "all_gather", lambda: gather_host(arr, self.comm_device, self.group)
        )


def gather_host(arr: np.ndarray, comm_device, group=None) -> np.ndarray:
    """Row-wise concatenation of every rank's host array: the row counts
    are gathered first (the collectives take equal sizes), then the rows
    as bytes, padded to the largest count."""
    arr = np.ascontiguousarray(arr)
    size = dist.get_world_size(group)
    rows = arr.shape[0]
    row_shape = arr.shape[1:]
    width = int(np.prod(row_shape, dtype=np.int64)) * arr.itemsize
    counts = torch.zeros(size, dtype=torch.int64, device=comm_device)
    dist.all_gather_into_tensor(
        counts, torch.tensor([rows], dtype=torch.int64, device=comm_device), group=group
    )
    counts = counts.cpu().numpy()
    per = int(counts.max())
    if per == 0 or width == 0:
        return np.zeros((int(counts.sum()),) + row_shape, arr.dtype)
    raw = np.zeros((per, width), np.uint8)
    raw[:rows] = arr.reshape(rows, width // arr.itemsize).view(np.uint8)
    out = torch.empty((size * per, width), dtype=torch.uint8, device=comm_device)
    dist.all_gather_into_tensor(out, torch.from_numpy(raw).to(comm_device), group=group)
    out = out.cpu().numpy()
    parts = [out[s * per : s * per + int(counts[s])] for s in range(size)]
    return np.concatenate(parts).reshape(-1).view(arr.dtype).reshape((-1,) + row_shape)


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` ("cuda" when None, the entry points'
    default), with a CUDA index of ``LOCAL_RANK`` (else the global rank)
    modulo the visible cards when none is given. Raises without a card."""
    dev = AK.resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh over the initialized ``torch.distributed`` world, one rank
    per device. With no world up, first starts a one-rank one (gloo for
    ``device="cpu"``, NCCL for a card; :func:`distributed.initialize`).
    Raises if ``n_devices`` differs from the world size, or if an NCCL
    world is asked for CPU tensors."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh({n_devices}) needs a world of {n_devices} ranks: start "
                "them under torchrun or with parallel.distributed.spawn"
            )
        from shasta_tpu_torch.parallel.distributed import initialize

        initialize(device=device)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"make_mesh({n_devices}): the torch.distributed world has {size} ranks "
            "(one rank per device)"
        )
    backend = str(dist.get_backend())
    dev = rank_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL mesh runs on CUDA devices, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dist.group.WORLD, backend, dev)


def fetch(x) -> np.ndarray:
    """Host copy of a mesh result. Every sharded function already returns
    the full result on every rank, so this is a plain device-to-host
    read (the JAX package's ``fetch`` all-gathers first)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def fetch_tree(x):
    """``fetch`` mapped over a tuple/list of arrays."""
    if isinstance(x, (tuple, list)):
        return type(x)(fetch_tree(e) for e in x)
    return fetch(x)


def multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def put_replicated(x, mesh: Mesh) -> torch.Tensor:
    """``x`` on this rank's device. Under SPMD every rank builds its own
    copy of replicated data, so this is a local upload."""
    return torch.as_tensor(np.asarray(x)).to(mesh.device)


# ---------------------------------------------------------------------------
# Sharded banded alignment (data-parallel over candidate pairs)
# ---------------------------------------------------------------------------


def _my_rows(mesh: Mesh, x, fill: int) -> torch.Tensor:
    """This rank's :meth:`Mesh.share` of a batch's rows, padded with
    ``fill`` rows (empty pairs) to :func:`share_rows`, on this rank's
    device: the batch padded to a multiple of D, dealt out evenly."""
    B = x.shape[0]
    per = share_rows(B, mesh.size)
    part = torch.as_tensor(x[mesh.share(B)]).to(mesh.device)
    if part.shape[0] < per:
        pad = torch.full(
            (per - part.shape[0],) + tuple(part.shape[1:]), fill,
            dtype=part.dtype, device=mesh.device,
        )
        part = torch.cat([part, pad])
    return part.to(torch.int32).contiguous()


def sharded_banded_forward(
    mesh: Mesh, a, a_len, b, b_len, band_min, *, W: int,
    match: int = 6, mismatch: int = -1, gap: int = -1,
):
    """The DP forward pass with pairs sharded over the ranks. Returns
    (best_i, best_d, best_val) (B,) int32 on every rank: the forward
    kernel's best-end row, lane and score (the plain version on the
    CPU)."""
    B = a.shape[0]
    LA, LB = a.shape[1], b.shape[1]
    args = AK.prepare_inputs(
        _my_rows(mesh, a, -1), _my_rows(mesh, a_len, 0), _my_rows(mesh, b, -2),
        _my_rows(mesh, b_len, 0), _my_rows(mesh, band_min, 0), LA=LA, LB=LB, W=W,
    )
    _dirs, best, bi, bd = AK.banded_fwd(
        *args, LA=LA, LB=LB, W=W, match=match, mismatch=mismatch, gap=gap
    )
    out = mesh.all_gather(torch.stack([bi, bd, best], dim=1))[:B]
    return out[:, 0], out[:, 1], out[:, 2]


def sharded_pallas_align(
    mesh: Mesh, a, a_len, b, b_len, band_min, *,
    LA: int, LB: int, W: int, match: int, mismatch: int, gap: int,
) -> torch.Tensor:
    """Forward + traceback (``align_kernel.banded_align_pairs``: the CUDA
    kernels on a card, the plain version on the CPU) with pairs sharded
    over the ranks; the fused (B, 16 + LA) int32 result on every rank.
    Any B: the batch is padded to a multiple of D with empty pairs."""
    B = a.shape[0]
    local = AK.banded_align_pairs(
        _my_rows(mesh, a, -1), _my_rows(mesh, a_len, 0), _my_rows(mesh, b, -2),
        _my_rows(mesh, b_len, 0), _my_rows(mesh, band_min, 0),
        LA=LA, LB=LB, W=W, match=match, mismatch=mismatch, gap=gap,
    )
    return mesh.all_gather(local)[:B]


def sharded_forward_traceback(
    mesh: Mesh, a, a_len, b, b_len, band_min, *,
    W: int, match: int, mismatch: int, gap: int, n_steps: Optional[int] = None,
) -> torch.Tensor:
    """Counterpart of the JAX package's jnp route
    (``sharded_forward_traceback``). The port has one DP for both of the
    JAX package's routes, so this is :func:`sharded_pallas_align` at
    LA, LB = the inputs' widths, and it returns the fused (B, 16 + LA)
    layout (matched ordinal1 per ordinal0), not the jnp route's
    (n_steps, B) match lists; ``n_steps`` is not used."""
    return sharded_pallas_align(
        mesh, a, a_len, b, b_len, band_min, LA=a.shape[1], LB=b.shape[1], W=W,
        match=match, mismatch=mismatch, gap=gap,
    )


def sharded_align_take(
    mesh: Mesh, mat_a, rowa, mat_b, rowb, a_len, b_len, band_min, *,
    LA: int, LB: int, W: int, match: int, mismatch: int, gap: int,
) -> torch.Tensor:
    """Take-feed + banded DP with pairs sharded over the ranks and the
    class matrices replicated (each rank's own copy): each rank takes and
    aligns only its share of the rows. The fused (B, 16 + LA) result on
    every rank, identical to the single-device take on the same rows. The
    JAX package's ``pack_u8`` layout has no counterpart in the port."""
    from shasta_tpu_torch.ops.align import _take_rows

    B = rowa.shape[0]
    a_len_r = _my_rows(mesh, a_len, 0)
    b_len_r = _my_rows(mesh, b_len, 0)
    a = _take_rows(mat_a, _my_rows(mesh, rowa, 0), a_len_r, -1)
    b = _take_rows(mat_b, _my_rows(mesh, rowb, 0), b_len_r, -2)
    local = AK.banded_align_pairs(
        a, a_len_r, b, b_len_r, _my_rows(mesh, band_min, 0),
        LA=LA, LB=LB, W=W, match=match, mismatch=mismatch, gap=gap,
    )
    return mesh.all_gather(local)[:B]


def sharded_band_take(
    mesh: Mesh, mat_a, rowa, ord_a, mat_b, rowb, ord_b, a_len, b_len, band_min, *,
    LA: int, LB: int, W: int, match: int, mismatch: int, gap: int,
) -> torch.Tensor:
    """Band discovery (take-feed -> DP -> band reduction on the device)
    with pairs sharded over the ranks. Returns (B, 3) int32
    [match_count, min_offset, max_offset] on every rank."""
    from shasta_tpu_torch.ops.align import _take_rows

    B = rowa.shape[0]
    ra = _my_rows(mesh, rowa, 0)
    rb = _my_rows(mesh, rowb, 0)
    a_len_r = _my_rows(mesh, a_len, 0)
    b_len_r = _my_rows(mesh, b_len, 0)
    fused = AK.banded_align_pairs(
        _take_rows(mat_a, ra, a_len_r, -1), a_len_r,
        _take_rows(mat_b, rb, b_len_r, -2), b_len_r, _my_rows(mesh, band_min, 0),
        LA=LA, LB=LB, W=W, match=match, mismatch=mismatch, gap=gap,
    )
    local = AK.band_reduce(
        fused[:, 16:], _take_rows(ord_a, ra, a_len_r, 0), _take_rows(ord_b, rb, b_len_r, 0)
    )
    return mesh.all_gather(local)[:B]


# ---------------------------------------------------------------------------
# Sharded LowHash feature hashing + bucket histogram (all-to-all shape)
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) held in int64, without an
    int64 overflow: the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix64(x: torch.Tensor, seed) -> torch.Tensor:
    """The JAX package's splitmix-style mixer on uint32 values
    (mesh.py:180), emulated in int64 with every step wrapped to 32 bits
    (``torch.uint32`` lacks most arithmetic kernels). ``x``: int64 in
    [0, 2**32); the result likewise."""
    h = (x & _M32) ^ (int(seed) & _M32)
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    return h ^ (h >> 16)


def _hash_features(feats: torch.Tensor, seeds) -> torch.Tensor:
    h = torch.zeros(feats.shape[0], dtype=torch.int64, device=feats.device)
    for j, s in enumerate(seeds):
        h = _mix64(feats[:, j] ^ h, s)
    return h


def _local_features(mesh: Mesh, features) -> torch.Tensor:
    """This rank's share of the (N, m) uint32 feature rows as int64."""
    f = np.asarray(features)[mesh.share(int(features.shape[0]))]
    return torch.from_numpy(f.astype(np.int64)).to(mesh.device)


def _bucket_hist(mesh: Mesh, h: torch.Tensor, n_buckets: int):
    bucket = (h & (n_buckets - 1)).to(torch.int32)
    hist = torch.bincount(bucket.to(torch.int64), minlength=n_buckets).to(torch.int32)
    return bucket, mesh.all_reduce(hist, "sum")


def sharded_lowhash_step(mesh: Mesh, features, seed: int, log2_buckets: int):
    """Hash features and histogram their bucket ids, reads sharded over
    the ranks and the histogram all-reduced (SUM): the collective
    skeleton of the LowHash bucket exchange. Returns (hash, bucket, hist)
    on every rank: hash (N,) int64 holding the uint32 values, bucket (N,)
    int32, hist (2**log2_buckets,) int32."""
    N, m = int(features.shape[0]), int(features.shape[1])
    h = _hash_features(_local_features(mesh, features), [seed * 37 + j for j in range(m)])
    bucket, hist = _bucket_hist(mesh, h, 1 << log2_buckets)
    return mesh.gather_rows(h, N), mesh.gather_rows(bucket, N), hist


def sharded_find_candidates(mesh: Mesh, markers, params, is_palindromic=None):
    """Full LowHash candidate generation with the bucket exchange as an
    ``all_to_all_single`` over the ranks (the multi-host skeleton
    BASELINE.json names: "LowHash buckets exchanged via all-to-all").

    Division of labor per iteration:
    - feature hashing runs on the host (MurmurHash64A, as the host path),
      replicated, so that every rank sizes the exchange buffer ``cap``
      alike;
    - rank r fills only its own source row ``buf[r]`` (D, cap, 4) of the
      entries of its reads (reads dealt contiguously over the ranks), one
      destination per bucket id modulo D, and the rows are exchanged;
    - each rank expands pairs for its own destination (the host path's
      sort/group code); the pair keys are gathered (counts first), then
      ``np.unique`` counts frequencies as the host path does.

    Produces exactly the host implementation's CandidatePairs at any D."""
    from shasta_tpu_torch.ops import lowhash as LH

    D = mesh.size
    r = mesh.rank
    n_or = markers.oriented_read_count

    log2_buckets = params.log2_bucket_count
    if log2_buckets == 0:
        log2_buckets = LH._auto_log2_bucket_count(
            markers.total_count, params.hash_fraction
        )
    mask = np.uint64((1 << log2_buckets) - 1)
    hash_threshold = np.uint64(
        min(int(params.hash_fraction * float(2**64)), 2**64 - 1)
    )
    exclude = None
    if is_palindromic is not None:
        exclude = np.repeat(is_palindromic, 2)
    min_bucket = max(2, params.min_bucket_size)
    prepared = LH.prepare_feature_index(markers, params.m, exclude, want_ordinals=False)

    pair_keys = []
    for it in range(params.iteration_count):
        orids, hashes = LH.compute_feature_hashes(
            markers, params.m, it * 37, exclude, prepared=prepared
        )
        low = hashes < hash_threshold
        orids, hashes = orids[low], hashes[low]
        if orids.shape[0] == 0:
            continue
        orids = orids.astype(np.int64)
        buckets = (hashes & mask).astype(np.int64)
        hash_high = (hashes >> np.uint64(32)).astype(np.int64)

        # Reads data-parallel: the source rank of each entry.
        src_dev = np.clip((orids * D) // (n_or if n_or else 1), 0, D - 1)
        dest_dev = buckets % D
        counts = np.bincount(src_dev * D + dest_dev, minlength=D * D)
        cap = max(8, int(counts.max()))
        # This rank's source row: its entries by destination, slot = rank
        # within the (source, destination) cell. Fields: orid, bucket,
        # hash_high lo16, hash_high hi16 (the 32 collision-filter bits
        # survive int32 transport).
        mine = np.flatnonzero(src_dev == r)
        order0 = mine[np.argsort(dest_dev[mine], kind="stable")]
        dest_s = dest_dev[order0]
        starts = np.concatenate(([0], np.cumsum(counts[r * D : (r + 1) * D])))[:-1]
        slot = np.arange(order0.shape[0], dtype=np.int64) - starts[dest_s]
        buf = np.full((D, cap, 4), -1, np.int32)
        buf[dest_s, slot, 0] = orids[order0]
        buf[dest_s, slot, 1] = (buckets[order0] & 0x7FFFFFFF).astype(np.int32)
        buf[dest_s, slot, 2] = (hash_high[order0] & 0xFFFF).astype(np.int32)
        buf[dest_s, slot, 3] = ((hash_high[order0] >> 16) & 0xFFFF).astype(np.int32)

        # After the exchange row s holds what source s sent to this rank.
        out = mesh.all_to_all(torch.from_numpy(buf).to(mesh.device)).cpu().numpy()

        # Pair expansion for this rank's destination (host).
        entries = out.reshape(-1, 4)
        entries = entries[entries[:, 0] >= 0]
        if entries.shape[0] == 0:
            continue
        o = entries[:, 0].astype(np.int64)
        b = entries[:, 1].astype(np.uint64)
        hh = entries[:, 2].astype(np.uint64) | (
            entries[:, 3].astype(np.uint64) << np.uint64(16)
        )
        order = np.argsort(b, kind="stable")
        b, o, hh = b[order], o[order], hh[order]
        is_new = np.empty(b.shape[0], dtype=bool)
        is_new[0] = True
        np.not_equal(b[1:], b[:-1], out=is_new[1:])
        gid = np.cumsum(is_new) - 1
        gsize = np.bincount(gid)
        ebs = gsize[gid]
        usable = (ebs >= min_bucket) & (ebs <= params.max_bucket_size)
        if not usable.any():
            continue
        ub, uo, uh = b[usable], o[usable], hh[usable]
        key = (ub << np.uint64(32)) | uh
        order2 = np.argsort(key, kind="stable")
        key, uo = key[order2], uo[order2]
        is_new2 = np.empty(key.shape[0], dtype=bool)
        is_new2[0] = True
        np.not_equal(key[1:], key[:-1], out=is_new2[1:])
        gid2 = np.cumsum(is_new2) - 1
        gsize2 = np.bincount(gid2)
        pairs = LH._pairs_within_groups(uo, gid2, gsize2)
        if pairs is not None:
            pair_keys.append(pairs)

    local = np.concatenate(pair_keys) if pair_keys else np.zeros(0, np.uint64)
    all_keys = mesh.gather_host(local.astype(np.uint64))
    if all_keys.shape[0] == 0:
        return LH.CandidatePairs(
            read_id0=np.zeros(0, np.int32),
            read_id1=np.zeros(0, np.int32),
            same_strand=np.zeros(0, bool),
            frequency=np.zeros(0, np.int32),
        )
    uniq, freq = np.unique(all_keys, return_counts=True)
    keep = freq >= params.min_frequency
    uniq, freq = uniq[keep], freq[keep]
    return LH.CandidatePairs(
        read_id0=(uniq >> np.uint64(33)).astype(np.int32),
        read_id1=((uniq >> np.uint64(1)) & np.uint64(0xFFFFFFFF)).astype(np.int32),
        same_strand=(uniq & np.uint64(1)).astype(bool),
        frequency=freq.astype(np.int32),
    )


# ---------------------------------------------------------------------------
# Sharded union-find (min-hooking + pointer jumping)
# ---------------------------------------------------------------------------


def _hooking_rounds(mesh: Mesh, n: int, u, v, n_rounds: int, jumps: int) -> torch.Tensor:
    """``n_rounds`` rounds of: each rank scatter-mins its edge share's
    proposals (the smaller endpoint label onto the larger), an all-reduce
    MIN combines them, then ``jumps`` pointer jumps. The labels after
    each round are those of one device running every edge, whatever D."""
    s = mesh.share(int(u.shape[0]))
    uu = torch.as_tensor(np.asarray(u)[s]).to(mesh.device, torch.int64)
    vv = torch.as_tensor(np.asarray(v)[s]).to(mesh.device, torch.int64)
    label = torch.arange(n, dtype=torch.int32, device=mesh.device)
    for _ in range(n_rounds):
        lu, lv = label[uu], label[vv]
        prop = label.clone().scatter_reduce_(
            0, torch.maximum(lu, lv).to(torch.int64), torch.minimum(lu, lv), "amin"
        )
        label = mesh.all_reduce(prop, "min")
        for _ in range(jumps):
            label = label[label.to(torch.int64)]
    return label


def sharded_union_find(mesh: Mesh, n: int, u, v, n_rounds: int = 16) -> torch.Tensor:
    """Connected-component labels via edge-parallel min-hooking: each
    rank proposes scatter-min updates from its edge share; proposals
    combine with an all-reduce MIN; 8 pointer jumps compress. Matches
    the host ``union_find_labels`` (label = min member id) for graphs
    whose components converge within ``n_rounds`` rounds. (n,) int32 on
    every rank."""
    return _hooking_rounds(mesh, n, u, v, n_rounds, jumps=8)


def sharded_union_find_labels(mesh: Mesh, n: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Host wrapper around :func:`sharded_union_find` for the pipeline:
    runs the min-hooking rounds over the ranks, then verifies convergence
    the way the reference audits its parent-flattening passes (reference:
    src/AssemblerMarkerGraph.cpp:141-151); any residual unions (rare:
    components with very long hooking chains) are finished on the host,
    so the result is always exactly the min-member labeling of
    ``union_find_labels``."""
    from shasta_tpu_torch.graph.marker_graph import union_find_labels

    if u.shape[0] == 0:
        return np.arange(n, dtype=np.int64)
    if n >= 2**31:
        # Device labels are int32; beyond that the label table must be
        # sharded too (future work), so the host runs it.
        return union_find_labels(n, u, v)
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    label = fetch(sharded_union_find(mesh, n, u, v)).astype(np.int64)
    # Convergence audit + host finish for any stragglers.
    while True:
        nl = label[label]
        if np.array_equal(nl, label):
            break
        label = nl
    lu, lv = label[u], label[v]
    diff = lu != lv
    if diff.any():
        lo = np.minimum(lu[diff], lv[diff])
        hi = np.maximum(lu[diff], lv[diff])
        while True:
            np.minimum.at(label, hi, lo)
            while True:
                nl = label[label]
                if np.array_equal(nl, label):
                    break
                label = nl
            lu, lv = label[u], label[v]
            diff = lu != lv
            if not diff.any():
                break
            lo = np.minimum(lu[diff], lv[diff])
            hi = np.maximum(lu[diff], lv[diff])
    return label


# ---------------------------------------------------------------------------
# One "full step": the compute core of the pipeline, sharded
# ---------------------------------------------------------------------------


def full_step(
    mesh: Mesh, features, a, a_len, b, b_len, band_min, unite_u, unite_v,
    n_markers: int, *, W: int = 128, log2_buckets: int = 8,
):
    """LowHash hashing -> banded alignment -> union-find, all sharded
    over the ranks: the three collective-bearing hot stages chained.
    Returns (hist, best_val, label) on every rank: the bucket histogram
    (all-reduce SUM), each pair's best DP score (the forward kernel on a
    card, its plain version on the CPU; the JAX package runs its jnp
    ``_banded_forward`` here) and 8 rounds of min-hooking with 2 pointer
    jumps each."""
    m = int(features.shape[1])
    h = _hash_features(_local_features(mesh, features), [37 + j for j in range(m)])
    _bucket, hist = _bucket_hist(mesh, h, 1 << log2_buckets)
    _bi, _bd, best_val = sharded_banded_forward(
        mesh, a, a_len, b, b_len, band_min, W=W, match=6, mismatch=-1, gap=-1
    )
    label = _hooking_rounds(mesh, n_markers, unite_u, unite_v, 8, jumps=2)
    return hist, best_val, label
