"""Work counts: the FLOPs and bytes a step asks of the card, the same
whichever route runs it (meta tensors, the CPU's plain versions, or the
CUDA kernels).

Two sources feed one count:

* **Kernel calls.**  Every call in :mod:`repro_torch.kernels.ops` reports
  its function-level work (a :class:`Work`) to an active
  :class:`CostCounter`, and the aten ops that carry it out (the plain
  version's on the CPU or on meta, the wrapper's allocations on CUDA) are
  not counted again.  The work formulas are the ones behind the bound
  column of ``PERF.md``'s kernel table, and ``chip_smoke.py`` reads them
  from here:

  - flash forward: two S x S x D products over the visible (query, key)
    pairs, ``4 * NQ * D * pairs`` FLOPs; q, k, v read and out (plus the f32
    LSE) written once;
  - flash backward: five such products (``s``, ``dp``, ``dv``, ``dq``,
    ``dk``), ``10 * NQ * D * pairs`` FLOPs; q, k, v, out, dout and the LSE
    read, dq, dk, dv written once;
  - ring and paged decode: ``4 * NQ * D`` FLOPs per live key; q read, out
    written, each live key's k and v read once, plus the slot positions
    (ring) or the page tables (paged) and the positions;
  - RMSNorm and the RG-LRU scan: each operand once; the scan's two
    (forward) or four (backward) f32 operations per element run on the CUDA
    cores (``f32_ops``), not in ``flops``.

  Where the work depends on values, a real tensor gives them (the prefix
  lengths, each row's live keys); a meta tensor has none, so the counter
  takes a prefix length from ``CostCounter(prefix_len=...)`` (the dry-run
  passes the config's ``num_prefix_tokens``) and counts every ring slot and
  every page a row's table holds as live (the dry-run's decode cells hold
  a full cache).

* **Every other aten op**, seen through a ``TorchDispatchMode``: FLOPs from
  ``torch.utils.flop_counter``'s registered formulas (matmuls, so
  elementwise ops count none, as in ``FlopCounterMode``), and bytes as the
  op's tensor operands plus its results, with four exceptions: view ops and
  allocations without a fill move nothing; ``.item()`` reads move a scalar
  to the host, not device work; ``copy_`` reads its source and writes its
  destination (it does not read the destination); an indexed write into a
  tensor (``index_copy_``, ``index_put_``, ``scatter_`` ...) reads its
  indices and source and writes as many bytes as the source holds, and an
  indexed read (``index``, ``gather``, ``index_select``, ``embedding``)
  reads its indices and writes its result, reading as many bytes of the
  table as it writes, not the whole table.

The counter sums ``flops``, ``bytes`` and ``f32_ops`` and keeps them per
aten op and per kernel, so two routes' counts can be told apart op by op.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils.flop_counter import flop_registry

__all__ = [
    "F32_FLOPS",
    "Work",
    "CostCounter",
    "active_counter",
    "visible_pairs",
    "flash_fwd_work",
    "flash_bwd_work",
    "decode_work",
    "paged_decode_work",
    "rms_norm_work",
    "rglru_scan_work",
    "rglru_scan_bwd_work",
]

F32_FLOPS = 67e12  # H100 SXM data sheet: f32 outside the tensor cores


@dataclasses.dataclass(frozen=True)
class Work:
    """What one call asks of the card: ``flops`` at the tensor cores' bf16
    peak, ``bytes`` through HBM, ``f32_ops`` on the CUDA cores."""

    flops: int = 0
    bytes: int = 0
    f32_ops: int = 0

    def bound(self):
        """``(ms, "bytes" or "operations")``: the least time the card could
        take (the H100 data sheet's rates, ``serving/profiles.py`` ``H100``),
        and which term sets it."""
        from repro_torch.serving.profiles import H100  # serving imports the model

        t_bytes = self.bytes / H100["hbm_bw"] * 1e3
        t_ops = max(self.flops / H100["peak_flops"], self.f32_ops / F32_FLOPS) * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# Work formulas (shapes and counts only, so meta tensors need no values).
# ---------------------------------------------------------------------------
def visible_pairs(S: int, *, causal: bool, window: int = 0, prefix: int = 0) -> int:
    """The (query, key) pairs of one row of an S-long sequence that the mask
    lets through: ``(causal & window) | (key < prefix)``, the JAX model's
    rule (``ref._scores_mask``)."""
    q = np.arange(S, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    hi = q if causal else np.full_like(q, S - 1)
    band = np.maximum(hi - lo + 1, 0)
    pre = min(prefix, S)
    overlap = np.maximum(np.minimum(hi, pre - 1) - lo + 1, 0) if pre else 0
    return int((band + pre - overlap).sum())


def flash_fwd_work(B, NQ, NKV, S, D, itemsize, pairs, lse=False) -> Work:
    """``pairs``: the visible pairs summed over the batch's rows."""
    nbytes = itemsize * (2 * B * NQ * S * D + 2 * B * NKV * S * D) + (4 * B * NQ * S if lse else 0)
    return Work(flops=4 * NQ * D * pairs, bytes=nbytes)


def flash_bwd_work(B, NQ, NKV, S, D, itemsize, pairs) -> Work:
    """q, out, dout, dq (q-sized), k, v, dk, dv (k-sized) and the f32 LSE."""
    nbytes = itemsize * (4 * B * NQ * S * D + 4 * B * NKV * S * D) + 4 * B * NQ * S
    return Work(flops=10 * NQ * D * pairs, bytes=nbytes)


def decode_work(B, NQ, NKV, D, S_cache, itemsize, live, lse: bool = False) -> Work:
    """One query per row against a ring of ``S_cache`` slots; ``live``: the
    live keys summed over the rows.  int32 slot positions and positions;
    with ``lse`` an f32 log-sum-exp per (row, query head) written too."""
    nbytes = (itemsize * (2 * B * NQ * D + 2 * live * NKV * D) + 4 * B * S_cache + 4 * B
              + (4 * B * NQ if lse else 0))
    return Work(flops=4 * NQ * D * live, bytes=nbytes)


def paged_decode_work(B, NQ, NKV, D, NB, itemsize, live) -> Work:
    """One query per row against its pages; ``NB`` int32 table entries per
    row; ``live``: the live keys summed over the rows."""
    nbytes = itemsize * (2 * live * NKV * D + 2 * B * NQ * D) + 4 * B * NB + 4 * B
    return Work(flops=4 * NQ * D * live, bytes=nbytes)


def rms_norm_work(n_x, x_itemsize, n_w, w_itemsize) -> Work:
    return Work(bytes=2 * n_x * x_itemsize + n_w * w_itemsize)


def rglru_scan_work(n, itemsize, n_h0, h0_itemsize) -> Work:
    """a and b read, h written (``n`` elements each), h0 read; a multiply
    and an add per element."""
    return Work(bytes=3 * n * itemsize + n_h0 * h0_itemsize, f32_ops=2 * n)


def rglru_scan_bwd_work(n, itemsize, n_h0, h0_itemsize) -> Work:
    """a, h, dh read, da, db written, h0 read, dh0 written; three multiplies
    and an add per element."""
    return Work(bytes=5 * n * itemsize + 2 * n_h0 * h0_itemsize, f32_ops=4 * n)


# ---------------------------------------------------------------------------
# The counter.
# ---------------------------------------------------------------------------
_aten = torch.ops.aten
_NO_DATA = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
            _aten.new_empty_strided, _aten._local_scalar_dense}
_INDEXED_WRITES = {_aten.index_copy_, _aten.index_put_, _aten._index_put_impl_,
                   _aten.index_add_, _aten.scatter_, _aten.scatter_add_,
                   _aten.scatter_reduce_, _aten.masked_scatter_}
_INDEXED_READS = {_aten.index, _aten.gather, _aten.index_select, _aten.embedding}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _op_bytes(packet, args, kwargs, out) -> int:
    ins = list(_tensors(list(args) + list(kwargs.values())))
    outs = list(_tensors(out))
    if packet is _aten.copy_:
        return 2 * _nbytes(ins[1:2])
    if packet in _INDEXED_WRITES:
        rest = ins[1:]
        return _nbytes(rest) + _nbytes(rest[-1:])
    if packet in _INDEXED_READS:  # ins[0] is the table
        return _nbytes(ins[1:]) + 2 * _nbytes(outs)
    return _nbytes(ins) + _nbytes(outs)


class CostCounter(TorchDispatchMode):
    """Counts the work of everything run inside ``with CostCounter() as c:``.

    ``c.flops``, ``c.bytes``, ``c.f32_ops``: the totals; ``c.by_op`` (aten
    op name -> [calls, flops, bytes]) and ``c.kernels`` (kernel name ->
    [calls, flops, bytes, f32_ops]) break them down.  ``prefix_len``: the
    prefix-LM length every row has, for meta traces (a real tensor's
    lengths are read from it)."""

    def __init__(self, prefix_len: Optional[int] = None):
        super().__init__()
        self.prefix_len = prefix_len
        self.flops = 0
        self.bytes = 0
        self.f32_ops = 0
        self.by_op: Dict[str, list] = {}
        self.kernels: Dict[str, list] = {}
        self._inside = 0

    def totals(self) -> Dict[str, int]:
        return {"flops": self.flops, "bytes": self.bytes, "f32_ops": self.f32_ops}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._inside:
            # A composite op reaches the mode undecomposed where autograd is
            # off (inference mode); count the ops it is made of, as
            # FlopCounterMode does.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if self._inside or func.is_view or packet in _NO_DATA:
            return out
        flops = int(flop_registry[packet](*args, **kwargs, out_val=out)) \
            if packet in flop_registry else 0
        nbytes = _op_bytes(packet, args, kwargs, out)
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.setdefault(str(packet), [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out

    @contextlib.contextmanager
    def kernel(self, name: str, work: Callable[[], Work]):
        """Count one kernel call's ``work()`` (computed here, its aten ops
        not counted) and none of the aten ops run inside the block."""
        self._inside += 1
        try:
            w = work()
            self.flops += w.flops
            self.bytes += w.bytes
            self.f32_ops += w.f32_ops
            row = self.kernels.setdefault(name, [0, 0, 0, 0])
            row[0] += 1
            row[1] += w.flops
            row[2] += w.bytes
            row[3] += w.f32_ops
            yield
        finally:
            self._inside -= 1


def active_counter() -> Optional[CostCounter]:
    """The innermost active :class:`CostCounter`, or None.  It is found on
    the dispatch-mode stack, which autograd carries into its backward
    threads, so a kernel's backward reports to the counter of its forward."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None
