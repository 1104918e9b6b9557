"""Picklable stub backends for the port's transport twins, beside
``transport_stubs.py``.  They import only the standard library and what
that module imports (numpy), so a spawned worker imports neither torch nor
jax.
"""
import signal
import time

from transport_stubs import StubWorkerBackend

HOLD_TOKEN = 1  # a batch whose first token is this one is held
HOLD_S = 60.0  # far past any stall or test timeout


class HoldingWorkerBackend(StubWorkerBackend):
    """Holds every batch whose first row starts with ``HOLD_TOKEN`` for
    ``HOLD_S`` seconds (until the worker is killed, in practice) and answers
    every other batch at once: a kill that follows the submit of a held
    batch always lands mid-batch, however late the worker reads it.

    The worker (which constructs this backend in its main thread) ignores
    SIGTERM, so it dies only when the scenario SIGKILLs it.  Both packages'
    ``kill()`` terminate the worker, then fail its in-flight batches with
    the kill's reason; a worker that died of the SIGTERM would race that
    with the transport's pump thread, which fails them ("worker process
    died") when it sees the pipe close, and whichever sets the death reason
    last wins.  With the SIGKILL after ``kill()`` returns, the kill's reason
    always comes first and the pump's always last."""

    def __init__(self):
        super().__init__()
        signal.signal(signal.SIGTERM, signal.SIG_IGN)

    def run_batch(self, name, batch, n_steps):
        if int(batch[0][0]) == HOLD_TOKEN:
            time.sleep(HOLD_S)
        return super().run_batch(name, batch, n_steps)
