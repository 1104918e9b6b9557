"""The loop's median queue wait (``CompletedRequest.queue_wait_ms``: the
dispatch tick less the request's due time) over the requests answered."""
from perfbench.yardstick import quantile


def read(run):
    waits = [r.queue_wait_ms for r in run.records if r.queue_wait_ms is not None]
    return quantile(waits, 50) if waits else None
