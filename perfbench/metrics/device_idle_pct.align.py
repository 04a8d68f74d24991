"""device_idle_pct.align: the share of the window in which no operation ran
on the device (torch.profiler's trace), in %."""

from perfbench.readers import idle_pct


def read(run):
    return idle_pct(run, "align")
