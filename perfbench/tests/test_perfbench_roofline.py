"""The frozen roofline arithmetic equals the program's on fixed pairs."""

import os
import sys

import pytest
import torch

from perfbench import roofline

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

PAIRS = [  # (LA, LB, W, B, seed)
    (128, 512, 128, 16, 1), (512, 2048, 512, 8, 2), (4096, 4096, 128, 4, 3),
    (8192, 8192, 2048, 2, 4), (300, 40, 64, 5, 5),
]


def inputs(LA, LB, W, B, seed):
    g = torch.Generator().manual_seed(seed)
    a_len = torch.randint(0, LA + 1, (B,), generator=g, dtype=torch.int32)
    b_len = torch.randint(0, LB + 1, (B,), generator=g, dtype=torch.int32)
    band_min = torch.randint(-(LA + W), LB + 1, (B,), generator=g, dtype=torch.int32)
    return a_len, b_len, band_min


@pytest.mark.parametrize("LA,LB,W,B,seed", PAIRS)
def test_fwd_work_equals_chip_smoke(LA, LB, W, B, seed):
    import chip_smoke

    a_len, b_len, band_min = inputs(LA, LB, W, B, seed)
    assert roofline.fwd_work(a_len, b_len, band_min, LA, LB, W) == \
        chip_smoke.fwd_work(a_len, b_len, band_min, LA, LB, W)


def test_cell_count_by_brute_force():
    a_len, b_len, band_min = inputs(40, 30, 16, 6, 9)
    want = 0
    for al, bl, bm in zip(a_len.tolist(), b_len.tolist(), band_min.tolist()):
        want += sum(1 for i in range(1, al + 1) for d in range(16) if 0 <= bm + i + d <= bl)
    assert roofline.in_matrix_cells(a_len, b_len, band_min, LA=40, W=16) == want


def test_bound_at_the_issue_limit():
    from shasta_tpu_torch.utils import peak

    assert roofline.issue_limit_ops(1980, 132) == peak.issue_limit_ops(1980, 132)
    t, by = roofline.bound_ms(33_454_080_000, 0, 1980, 132)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = roofline.bound_ms(0, 3.35e9, 1980, 132)
    assert by == "bytes" and t == pytest.approx(1.0)


class _Event:
    def elapsed_time(self, _end):
        return 1.0


@pytest.mark.parametrize("name", ["banded_fwd", "banded_tb"])
@pytest.mark.parametrize("LA,LB,W,B,seed", PAIRS[:3])
def test_launch_bound_equals_chip_smokes_classes(name, LA, LB, W, B, seed, monkeypatch):
    import types

    import chip_smoke

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda _d: types.SimpleNamespace(multi_processor_count=132))
    a_len, b_len, band_min = inputs(LA, LB, W, B, seed)
    work = (a_len, b_len, band_min, LB) if name == "banded_fwd" else (a_len,)
    row = chip_smoke.kernel_classes([(name, "x", LA, W, B, work, _Event(), _Event())], 1980.0,
                                    "test", echo=False)[0]
    assert roofline.launch_bound_ms(name, work, LA, W, B, 1980.0, 132) == \
        pytest.approx(row["bound_ms"], rel=1e-12)
