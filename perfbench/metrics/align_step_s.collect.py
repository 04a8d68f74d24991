"""align_step_s.collect: seconds per pass in the program's span
``stage:align.collect`` (the host's collection: both sweeps over the phase-2
batches and the scatter into the output CSR, to the AlignmentStore), on the
host's clock of the device trace."""

from perfbench.spans import seconds_per_pass


def read(run):
    return seconds_per_pass(run, "stage:align.collect")
