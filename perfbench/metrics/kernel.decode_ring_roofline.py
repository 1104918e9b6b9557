"""The ring decode kernel's share of its roofline: the bound time of the
decode steps that the requests whose remote leg finished needed (one per
answer token after the first, over the live keys) over the device time of
the remote model's bf16 decode kernels."""
from perfbench.metrics_common import is_kernel
from perfbench.yardstick import bound_s, decode_work


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.op_seconds(lambda n: is_kernel(n, "decode_split_kernel"))
    if spent <= 0:
        return None
    c = run.remote_cfg
    need = sum(bound_s(*decode_work(1, c.n_heads, c.n_kv_heads, c.head_dim, run.max_len, 2,
                                    r.prompt_len + j))
               for r in run.records if r.remote_ms is not None
               for j in range(1, r.n_steps)) * c.n_layers
    return 100.0 * need / spent
