"""The flash forward's share of its roofline: the bound time of the
prefills that the requests whose remote leg finished needed (each prompt
alone, causal, every layer) over the device time of the remote model's
bf16 flash forward kernels."""
from perfbench.metrics_common import is_kernel
from perfbench.yardstick import bound_s, causal_pairs, flash_fwd_work


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.op_seconds(lambda n: is_kernel(n, "flash_fwd"))
    if spent <= 0:
        return None
    c = run.remote_cfg
    need = sum(bound_s(*flash_fwd_work(1, c.n_heads, c.n_kv_heads, r.prompt_len, c.head_dim,
                                       2, causal_pairs(r.prompt_len)))
               for r in run.records if r.remote_ms is not None) * c.n_layers
    return 100.0 * need / spent
