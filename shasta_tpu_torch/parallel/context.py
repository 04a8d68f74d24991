"""Ambient mesh context: stages opt into multi-device execution when a
mesh is active.

Counterpart of ``shasta_tpu/parallel/context.py``. The reference
parallelizes every hot stage through one shared thread pool owned by the
Assembler (reference: src/MultithreadedObject.hpp:33-99); here the
shared resource is the port's :class:`~shasta_tpu_torch.parallel.mesh.Mesh`
(one rank of a ``torch.distributed`` world). The pipeline installs it
once and the ops-level dispatchers pick it up, so the same call sites
work on one device and on many.
"""

from __future__ import annotations

import contextlib

_current = None


def current_mesh():
    """The active mesh, or None for single-device execution."""
    return _current


def mesh_size() -> int:
    return _current.size if _current is not None else 1


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the ambient mesh for the dynamic extent."""
    global _current
    prev = _current
    _current = mesh
    try:
        yield mesh
    finally:
        _current = prev
