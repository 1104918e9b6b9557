"""Set-up: from the start of the process to the window's start (imports,
weights, engine, the profiles the system measures, kernel builds)."""


def read(run):
    return run.setup_s
