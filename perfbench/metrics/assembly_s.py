"""assembly_s: the window's seconds over the whole assemblies completed in it."""


def read(run):
    if run.kind != "assemble" or not run.items:
        return None
    return run.window_s / run.items
