"""Aggregate accuracy: the mean, over every request sent, of the quality of
the answer the user got (the remote model's if its answer resolved the
race, the hedge model's if the hedge's did, 0 if none came)."""


def read(run):
    remote_q = float(run.cell.config["quality"])
    hedge_q = float(run.cell.hedge["quality"])
    total = sum((remote_q if r.used_remote else hedge_q) if r.answered else 0.0
                for r in run.records)
    return total / len(run.records) if run.records else None
