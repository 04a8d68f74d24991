"""Multi-process execution: the torch.distributed world, the global mesh,
input distribution, output gathering, and a local spawner.

Counterpart of ``shasta_tpu/parallel/distributed.py``. The reference is
strictly single-node shared memory (reference:
src/MultithreadedObject.hpp:33-99). The port's scale-out axis is a
``torch.distributed`` world with one rank per device: every rank runs
the whole pipeline (SPMD); the hot stages shard over the global mesh
(LowHash bucket exchange, alignment batches and union-find hooking ride
collectives, see parallel/mesh.py), and rank 0 writes the output files
(the analog of the reference's single-process writers,
srcMain/main.cpp:822-830).

On a host with one card per rank, launch under ``torchrun`` with NCCL
(``initialize`` adopts the world its environment describes); ranks on
the CPU, or sharing one card, use gloo. :func:`spawn` starts n local
ranks for the tests and the dry run. A single process is the degenerate
case: ``initialize()`` with no launcher environment starts a one-rank
world.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from shasta_tpu_torch.parallel.mesh import (
    Mesh, gather_host, make_mesh, rank_device, rank_share,
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(backend: Optional[str] = None, device=None) -> None:
    """Bring up the torch.distributed world (idempotent).

    An initialized world is adopted as it is. Under a launcher that sets
    ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` (``torchrun``) the world
    it describes is joined (``env://``). Otherwise a local one-rank world
    starts at a free localhost port. ``backend`` defaults to NCCL for a
    ``device`` on a card ("cuda" when None) and gloo for the CPU."""
    if dist.is_initialized():
        return
    dev = rank_device(device)
    backend = backend or default_backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0
        )


def _world():
    """(size, rank) of the world, (1, 0) when none is up."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def is_coordinator() -> bool:
    """True on the rank that owns output writing (rank 0)."""
    return _world()[1] == 0


def global_mesh(device=None) -> Mesh:
    """The 1-D mesh over every rank of the world."""
    return make_mesh(device=device)


def process_local_slice(n: int) -> slice:
    """The contiguous [start, stop) shard of ``n`` items this rank owns
    (reads dealt out contiguously so read ids stay globally dense), by the
    mesh's one sharding rule (``parallel.mesh.rank_share``)."""
    return rank_share(n, *_world())


def shard_input_files(input_files: Sequence[str]) -> List[str]:
    """Deal input files round-robin over ranks; with fewer files than
    ranks every rank gets all files (the JAX package's convention).
    :func:`run_assembly_distributed` does not use it: the pipeline never
    gathers the reads back, so ranks given different files assemble
    different read sets (ROADMAP.md, queue 3)."""
    p, i = _world()
    if p == 1 or len(input_files) < p:
        return list(input_files)
    return [f for j, f in enumerate(input_files) if j % p == i]


def _comm_device() -> torch.device:
    if str(dist.get_backend()) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_to_hosts(arr: np.ndarray) -> np.ndarray:
    """Concatenate per-rank host arrays onto every rank (row-wise, rank
    order; the row counts may differ)."""
    if _world()[0] == 1:
        return np.asarray(arr)
    return gather_host(np.asarray(arr), _comm_device())


def barrier() -> None:
    """Cross-rank sync point (stage fences between pipeline stages)."""
    if _world()[0] == 1:
        return
    if str(dist.get_backend()) == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def run_assembly_distributed(
    input_files: List[str],
    run_dir: str,
    config=None,
    device=None,
    backend: Optional[str] = None,
):
    """Multi-process entry point: initialize the world, build the global
    mesh, execute the pipeline sharded over it, and write outputs on rank
    0 only (the others write ``run_dir/.process{i}``, so the writers
    never race). Returns the summary dict on rank 0, None elsewhere.

    Every rank reads every input file, so the output is the one-process
    output. (The JAX package deals the files out with
    :func:`shard_input_files`, which gives ranks different read sets.)
    ``device``: this rank's device, the card by default."""
    from shasta_tpu_torch.pipeline.assemble import run_assembly

    initialize(backend=backend, device=device)
    barrier()
    mesh = global_mesh(device=device)
    if not is_coordinator():
        run_dir = os.path.join(run_dir, f".process{mesh.rank}")
    summary = run_assembly(list(input_files), run_dir, config, mesh=mesh)
    barrier()
    return summary if is_coordinator() else None


# ---------------------------------------------------------------------------
# A local spawner: n ranks on this host
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, n, backend, device, port, args, results) -> None:
    try:
        os.environ["LOCAL_RANK"] = str(rank)
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", world_size=n, rank=rank
        )
        try:
            out = fn(make_mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, n_ranks: int, *, device, backend: Optional[str] = None,
          args=(), timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` new local processes that
    form one ``torch.distributed`` world (``backend``: NCCL for a card,
    gloo for the CPU by default; ranks that share a card need gloo) and
    return each rank's result, in rank order. ``fn`` and ``args`` are
    pickled (``fn`` by import path); so is each result. Raises with the
    rank's traceback if any rank fails, and after ``timeout`` seconds;
    every process is ended before it returns."""
    backend = backend or default_backend(device)
    if backend == "nccl" and n_ranks > torch.cuda.device_count():
        raise ValueError(
            f"NCCL takes one rank per card: {n_ranks} ranks, "
            f"{torch.cuda.device_count()} cards (ranks that share a card use gloo)"
        )
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(fn, r, n_ranks, backend, str(device), port, tuple(args), results),
        )
        for r in range(n_ranks)
    ]
    for p in procs:
        p.start()
    got, failed = {}, {}
    deadline = time.monotonic() + timeout
    try:
        # A failed rank leaves the others waiting in a collective: stop
        # at the first failure, or at a rank that died without a word.
        while len(got) < n_ranks and not failed:
            wait = deadline - time.monotonic()
            if wait <= 0:
                break
            try:
                rank, ok, payload = results.get(timeout=min(wait, 5.0))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            (got if ok else failed)[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=1 if failed or len(got) < n_ranks else 30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        r = min(failed)
        raise RuntimeError(f"rank {r} of {n_ranks} failed:\n{failed[r]}")
    if len(got) < n_ranks:
        missing = sorted(set(range(n_ranks)) - set(got))
        codes = {r: procs[r].exitcode for r in missing}
        raise TimeoutError(
            f"ranks {missing} of {n_ranks} gave no result within {timeout:.0f} s "
            f"(exit codes {codes})"
        )
    return [got[r] for r in range(n_ranks)]
