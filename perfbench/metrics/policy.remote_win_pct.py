"""Share of the requests sent that the remote tier answered
(``CompletedRequest.used_remote``)."""


def read(run):
    if not run.records:
        return None
    return 100.0 * sum(bool(r.used_remote) for r in run.records) / len(run.records)
