"""candidates_per_s: candidates aligned in the window's whole passes over
the window's seconds."""


def read(run):
    if run.candidates is None:
        return None
    return run.candidates / run.window_s
