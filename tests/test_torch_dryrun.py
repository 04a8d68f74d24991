"""The port's dry run (shasta_tpu_torch/entry.py) against the JAX
package's (__graft_entry__.py).

``dryrun_multichip(2)`` spawns two gloo ranks on the CPU and prints one
line of values (the histogram total, the mean best score, the component
count, the sharded candidate count, the mesh assembly's bases and the
mode-2 bubbles phased); it must equal, character for character, the line
the JAX ``dryrun_multichip(2)`` prints on its CPU mesh, from the same
seeded draws. The two run at once: the port's ranks in a thread."""

import threading

import numpy as np

import __graft_entry__ as G
from shasta_tpu_torch import entry as E
from tests.torch_common import one_torch_thread  # noqa: F401


def test_entry_step_equals_jax_entry():
    """entry(): the forward kernel's best scores (its plain version on
    the CPU) equal the JAX step's on the same arguments."""
    step, args = E.entry(device="cpu")
    ref_step, ref_args = G.entry()
    got = step(*args).numpy()
    assert np.array_equal(got, np.asarray(ref_step(*ref_args)))
    assert (got > 0).all()


def test_dryrun_multichip_2_equals_jax(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks share the test's cores
    box = {}

    def port():
        try:
            box["line"] = E.dryrun_multichip(2, device="cpu", timeout=600)
        except BaseException as e:  # re-raised below, in the test's thread
            box["error"] = e

    t = threading.Thread(target=port)
    t.start()
    try:
        G.dryrun_multichip(2)
    finally:
        t.join(timeout=660)
    assert not t.is_alive()
    if "error" in box:
        raise box["error"]
    lines = [
        ln for ln in capsys.readouterr().out.splitlines()
        if ln.startswith("dryrun_multichip(2): ok")
    ]
    assert len(lines) == 2 and lines[0] == lines[1] == box["line"], lines
