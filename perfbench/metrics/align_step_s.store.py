"""align_step_s.store: seconds per pass in the program's span ``stage:align.store``
(the ordinals' audit, the Alignments stage written, gc.collect and
malloc_trim), on the host's clock of the device trace."""

from perfbench.spans import seconds_per_pass


def read(run):
    return seconds_per_pass(run, "stage:align.store")
