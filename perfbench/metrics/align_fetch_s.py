"""align_fetch_s: seconds per pass in the program's span ``stage:align.fetch``,
the host blocked on a device-to-host fetch: its wait for the device and
the pageable copy."""

from perfbench.spans import seconds_per_pass


def read(run):
    return seconds_per_pass(run, "stage:align.fetch")
