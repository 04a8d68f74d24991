"""align_step_s.phase1: seconds per pass in the program's span ``stage:align.phase1``
(phase 1's dispatch: the diagonal bands of wide pairs, the bucketing, the
downsampled markers' device CSR and every phase-1 launch), on the host's
clock of the device trace."""

from perfbench.spans import seconds_per_pass


def read(run):
    return seconds_per_pass(run, "stage:align.phase1")
