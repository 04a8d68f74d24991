"""align_step_s.phase2: seconds per pass in the program's span ``stage:align.phase2``
(phase 2's dispatch: each phase-1 band batch fetched, the pairs it keeps
dispatched (and the early drain), then the last classes flushed), on the
host's clock of the device trace."""

from perfbench.spans import seconds_per_pass


def read(run):
    return seconds_per_pass(run, "stage:align.phase2")
