"""Fixtures of the benchmark's own tests (CPU; the ``cuda`` ones skip
without a card).

    python -m pytest perfbench/tests -q
"""

import os
import sys

# Tiny runs in several test workers: one thread each, or the CPU's
# thread pools contend and a seconds-long run takes minutes.
os.environ.setdefault("OMP_NUM_THREADS", "1")

import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from perfbench.tests import tiny  # noqa: E402


def pytest_configure(config):
    import torch

    torch.set_num_threads(1)
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with the cut-size cells ``tiny.align`` and
    ``tiny.assemble`` added by new files and entries only."""
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return "cuda"
