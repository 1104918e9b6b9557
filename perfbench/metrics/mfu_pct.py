"""The remote model's FLOPs that the requests whose remote leg finished
needed (their own prompt and answer tokens; no padding, no repeated work)
over the traced window at the card's bf16 peak."""
from perfbench.yardstick import PEAKS, request_flops


def read(run):
    if run.trace is None:
        return None
    flops = sum(request_flops(run.remote_cfg, r.prompt_len, r.n_steps)
                for r in run.records if r.remote_ms is not None)
    return 100.0 * flops / (run.trace.window_s * PEAKS["bf16_flops"])
