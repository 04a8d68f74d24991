"""shasta_tpu_torch — the PyTorch/CUDA port of shasta_tpu.

The port mirrors ``shasta_tpu``'s layout module by module. Host stages
(reads, k-mers, markers, LowHash) are numpy, as in the JAX package; the
banded marker-alignment DP runs as hand-written CUDA kernels
(``csrc/banded_align.cu``) on an NVIDIA card, with a plain PyTorch
version of the same DP for CPU tensors. The package never imports
``jax`` or ``shasta_tpu``.
"""

from shasta_tpu_torch.version import __version__

__all__ = ["__version__", "Assembler", "AssemblyConfig", "configuration_table"]

_LAZY = {
    "Assembler": ("shasta_tpu_torch.pipeline.assemble", "Assembler"),
    "AssemblyConfig": ("shasta_tpu_torch.pipeline.config", "AssemblyConfig"),
    "configuration_table": (
        "shasta_tpu_torch.pipeline.configurations",
        "CONFIGURATIONS",
    ),
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module 'shasta_tpu_torch' has no attribute {name!r}"
        )
    import importlib

    module = importlib.import_module(target[0])
    return getattr(module, target[1])
