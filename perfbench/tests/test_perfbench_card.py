"""On the card: a cut-size cell end to end, checked."""

import json

import pytest

from perfbench.tests import tiny


@pytest.mark.cuda
def test_tiny_align_on_the_card(cuda_device, tiny_root, capsys):
    assert tiny.run(tiny_root, "tiny.align", device=cuda_device) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
