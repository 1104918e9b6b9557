"""Requests in each remote ``generate`` call, mean over the window's ticks:
``TickStats.n_requests`` less ``n_degraded`` (one remote tier); the rows
padded up to a power of two are not counted."""


def read(run):
    rows = [t.n_requests - t.n_degraded for t in run.ticks if t.n_requests - t.n_degraded > 0]
    return sum(rows) / len(rows) if rows else None
