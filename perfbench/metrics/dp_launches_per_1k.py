"""dp_launches_per_1k: launches of the DP kernels (the program's
align_kernel.LAUNCHES) per 1,000 candidates aligned in the window."""


def read(run):
    if not run.candidates or not run.launches:
        return None
    return run.launches * 1000.0 / run.candidates
