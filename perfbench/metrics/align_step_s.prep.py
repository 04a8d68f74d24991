"""align_step_s.prep: seconds per pass in the program's span ``stage:align.prep``
(the downsampled markers' selection, their CSR offsets and the phase-2
runner's device CSR (its upload included)), on the host's clock of the
device trace."""

from perfbench.spans import seconds_per_pass


def read(run):
    return seconds_per_pass(run, "stage:align.prep")
