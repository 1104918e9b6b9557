"""RG-LRU scan kernel (CUDA C++, ``csrc/rglru_scan.cu``), forward and backward.

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py``
(``rglru_scan_fwd``, ``pallas_call`` at :59, ``_kernel`` at :27): the
linear recurrence ``h_t = a_t * h_{t-1} + b_t`` from ``h0`` with an f32
carry.  The wrapper keeps the JAX kernel's layout and signature (a, b (B,
S, W); h0 (B, W)); operands are read through (batch, seq) strides with a
contiguous channel dim.

The kernel cuts S into chunks of L steps across the blocks of a
thread-block cluster (up to 8; the cluster loops over groups of 8 chunks
when S is longer): each block folds its chunk into an affine summary, the
blocks fold the summaries onto the carry in chunk order through
distributed shared memory, and each block re-walks its chunk from its
carry.  The source file's header gives the bound and the design;
:func:`ref.rglru_scan_chunked_ref` is the same arithmetic in plain
PyTorch.  :func:`scan_plan` picks (L, channels a block, cluster size,
stages) for a shape; :func:`load_route` picks how the tiles reach shared
memory.  Both are pure Python, so the CPU tests reach them.

:func:`rglru_scan_bwd` is the gradient on the card: the same kernel run in
reverse (``g_t = dh_t + a_{t+1} g_{t+1}`` walked from S-1 down) with an
epilogue that writes ``da``, ``db`` and ``dh0``: one launch, no copies.
The JAX package has no Pallas backward here (its gradient is ``jax.grad``
of the associative scan).

Nothing falls back: a cluster launch the card refuses, a TMA map that does
not encode and a shape no plan fits all raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.cuda_build import check_launch, library
from repro_torch.kernels.flash_attention import DTYPE_CODES

__all__ = ["rglru_scan_fwd", "rglru_scan_bwd", "ScanPlan", "make_plan", "scan_plan",
           "launch_plan", "load_route", "smem_bytes", "launches", "bwd_launches"]

launches = LaunchCounter("rglru_scan_fwd")
bwd_launches = LaunchCounter("rglru_scan_bwd")

MAX_CLUSTER = 8  # the portable thread-block cluster size
CHUNKS = (128, 64, 32, 16, 8)  # steps a chunk, longest first (a TMA box is <= 256 rows)
SMEM_LIMIT = 232448  # shared memory one block of an H100 may use
_ERR_TMA, _ERR_PLAN = -1, -2  # the entry point's codes besides cudaError_t's


class ScanPlan(NamedTuple):
    chunk: int     # L, steps a chunk
    tile_w: int    # Wt, channels a block (one thread each)
    cluster: int   # K, blocks a cluster: min(8, n_chunks)
    n_tiles: int   # channel tiles, ceil(W / Wt)
    n_chunks: int  # ceil(S / L)
    groups: int    # ceil(n_chunks / K): the cluster's loop over S
    stages: int    # tile buffers: 2 when there is a next group to load ahead
    smem: int      # dynamic shared memory a block, bytes
    blocks: int    # K * n_tiles * B


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round128(n: int) -> int:
    return _cdiv(n, 128) * 128


def smem_bytes(itemsize: int, reverse: bool, chunk: int, tile_w: int, stages: int) -> int:
    """The kernel's shared memory a block (``csrc/rglru_scan.cu``
    ``smem_bytes``): per stage a tile of each operand (forward a, b; reverse
    a with one halo step, dh, h), each padded to 128 bytes; then the
    summaries (A and H, two buffers, f32) and an mbarrier per stage."""
    rows = (chunk + 1, chunk, chunk) if reverse else (chunk, chunk)
    tiles = sum(_round128(r * tile_w * itemsize) for r in rows)
    return stages * tiles + 4 * tile_w * 4 + 2 * 8


def make_plan(B: int, S: int, W: int, itemsize: int, reverse: bool, chunk: int,
              tile_w: int) -> ScanPlan:
    """The plan with chunks of ``chunk`` steps and ``tile_w`` channels a
    block: cluster size ``min(8, n_chunks)``, two stages when the cluster
    loops over more than one group."""
    n_chunks = _cdiv(S, chunk)
    cluster = min(MAX_CLUSTER, n_chunks)
    groups = _cdiv(n_chunks, cluster)
    stages = 2 if groups > 1 else 1
    n_tiles = _cdiv(W, tile_w)
    return ScanPlan(chunk, tile_w, cluster, n_tiles, n_chunks, groups, stages,
                    smem_bytes(itemsize, reverse, chunk, tile_w, stages), cluster * n_tiles * B)


def scan_plan(B: int, S: int, W: int, itemsize: int, reverse: bool,
              active_clusters: Callable[[ScanPlan], int]) -> ScanPlan:
    """The launch for a (B, S, W) scan of ``itemsize``-byte elements.

    S <= 128: one chunk (the shortest of :data:`CHUNKS` >= S), a cluster of
    one, 32 channels a block: the walk from h0 needs no summary and no fold,
    and narrow blocks spread the rows over the most SMs.  Longer S: 32, 64
    or 128 channels a block (the least power of two >= W, up to 128) and the
    longest chunk of :data:`CHUNKS` that gives a full cluster of 8 chunks
    and whose B * ceil(W / Wt) clusters are all resident at once by
    ``active_clusters(plan)`` (the card's occupancy); if none is, the
    shortest chunk that fits the card at all.  Raises ``ValueError`` for an
    empty shape, B > 65535 or a shape no plan fits."""
    if B <= 0 or S <= 0 or W <= 0:
        raise ValueError(f"rglru_scan: empty shape {(B, S, W)}")
    if B > 65535:
        raise ValueError(f"rglru_scan: batch {B} > 65535 (the grid's y dimension)")
    if S <= CHUNKS[0]:
        candidates = [make_plan(B, S, W, itemsize, reverse, min(c for c in CHUNKS if c >= S), 32)]
    else:
        tile_w = 32 if W <= 32 else 64 if W <= 64 else 128
        candidates = [make_plan(B, S, W, itemsize, reverse, chunk, tile_w) for chunk in CHUNKS
                      if S >= MAX_CLUSTER * chunk or chunk == CHUNKS[-1]]
    fallback = None
    for plan in candidates:
        if plan.smem > SMEM_LIMIT:
            continue
        resident = active_clusters(plan)
        if resident >= B * plan.n_tiles:
            return plan
        if resident > 0:
            fallback = plan
    if fallback is None:
        raise ValueError(f"rglru_scan: no plan fits {(B, S, W)} ({itemsize}-byte elements, "
                         f"reverse={reverse}) on this card")
    return fallback


def _tma_ok(ptr: int, sb: int, ss: int, B: int, S: int, W: int, esz: int) -> bool:
    """Whether an operand at ``ptr`` with (batch, step) element strides
    ``sb``, ``ss`` can be a TMA tensor map: 16-byte pointer and byte strides
    (below 2^40), rows that do not overlap.  The stride of a size-1 dim is
    not looked at."""
    if ptr % 16:
        return False
    if S > 1 and (ss < W or ss * esz % 16 or ss * esz >= 2**40):
        return False
    return B == 1 or not (sb < (S - 1) * ss + W or sb * esz % 16 or sb * esz >= 2**40)


def load_route(*operands) -> str:
    """How the kernel's tiles reach shared memory for these (B, S, W)
    operands: ``"tma"`` (TMA boxes) when every one passes the alignment
    check, else ``"ldg"`` (each thread loads its channel's steps)."""
    ok = all(_tma_ok(t.data_ptr(), *t.stride()[:2], *t.shape, t.element_size())
             for t in operands)
    return "tma" if ok else "ldg"


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("rglru_scan")
    lib.rglru_scan_launch.argtypes = ([_I] * 6 + [_P, _L, _L] * 3 + [_P, _L]
                                      + [_P, _L, _L] * 2 + [_P] + [_I] * 5 + [_L, _P])
    lib.rglru_scan_launch.restype = ctypes.c_int
    lib.rglru_scan_active_clusters.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
    lib.rglru_scan_active_clusters.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _active_clusters(index: int, code: int, reverse: bool, chunk: int, tile_w: int,
                     cluster: int, stages: int) -> int:
    """Clusters of this plan that device ``index`` holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = _lib()
    n = _I(0)
    with torch.cuda.device(index):
        err = lib.rglru_scan_active_clusters(int(reverse), code, chunk, tile_w, cluster, stages,
                                             ctypes.byref(n))
    check_launch(lib, err, "rglru_scan (occupancy)")
    return n.value


@functools.lru_cache(maxsize=None)
def _plan(index: int, code: int, itemsize: int, reverse: bool, B: int, S: int, W: int):
    return scan_plan(B, S, W, itemsize, reverse, lambda p: _active_clusters(
        index, code, reverse, p.chunk, p.tile_w, p.cluster, p.stages))


def launch_plan(a, reverse: bool = False) -> ScanPlan:
    """The plan :func:`rglru_scan_fwd` (``reverse`` False) or
    :func:`rglru_scan_bwd` launches for a CUDA ``a`` (B, S, W): made once per
    shape (the occupancy query included), so call it before a CUDA-graph
    capture."""
    B, S, W = a.shape
    return _plan(a.device.index, DTYPE_CODES[a.dtype], a.element_size(), bool(reverse),
                 B, S, W)


def _check(what, ref, named):
    for name, t in named:
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be on {ref.device} (CUDA)")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last dim")


def _ptr3(t):
    """(pointer, batch stride, step stride) of an operand, or nulls."""
    return (None, 0, 0) if t is None else (t.data_ptr(), *t.stride()[:2])


def _launch(what, reverse, a, xs, h0, ys, dh0, plan):
    """One launch of the kernel with ``plan`` over operands ``xs`` (a, b or
    a, dh, h) into ``ys`` (h or da, db), on the operands' route; raises on
    any error."""
    B, S, W = a.shape
    x0, x1, x2 = (*xs, None)[:3]
    y0, y1 = (*ys, None)[:2]
    device = a.device
    args = (int(reverse), DTYPE_CODES[a.dtype], DTYPE_CODES[h0.dtype], B, S, W,
            *_ptr3(x0), *_ptr3(x1), *_ptr3(x2), h0.data_ptr(), h0.stride(0),
            *_ptr3(y0), *_ptr3(y1), None if dh0 is None else dh0.data_ptr(),
            plan.chunk, plan.tile_w, plan.cluster, plan.stages,
            int(load_route(*xs) == "tma"), plan.smem,
            torch.cuda.current_stream(device).cuda_stream)
    lib = _lib()
    if torch.cuda.current_device() == device.index:
        err = lib.rglru_scan_launch(*args)
    else:
        with torch.cuda.device(device):
            err = lib.rglru_scan_launch(*args)
    if err == _ERR_TMA:
        raise RuntimeError(f"{what}: a TMA tensor map did not encode for {(B, S, W)} "
                           f"{a.dtype} (strides {[t.stride() for t in xs]})")
    if err == _ERR_PLAN:
        raise RuntimeError(f"{what}: plan {plan} does not fit the kernel's launch")
    check_launch(lib, err, what)


def rglru_scan_fwd(a, b, h0, *, plan=None):
    """a, b: (B, S, W) of one dtype (f32, bf16 or f16); h0: (B, W) of any of
    the three.  Returns h (B, S, W) in a's dtype with ``h_t = a_t * h_{t-1}
    + b_t`` (``h_{-1} = h0``), carried in f32.  Any S and W; each operand
    needs a contiguous last dim, other strides are free.  ``plan`` replaces
    :func:`launch_plan`'s (a :func:`make_plan` of the same shape), to
    exercise or time another chunking."""
    _check("rglru_scan_fwd", a, (("a", a), ("b", b), ("h0", h0)))
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype or h0.dtype not in DTYPE_CODES:
        raise TypeError(f"rglru_scan_fwd: dtypes a={a.dtype} b={b.dtype} h0={h0.dtype} "
                        "not supported (a and b alike; f32, bf16 or f16)")
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan_fwd: shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)}; need (B, S, W), (B, S, W), (B, W)")
    B, S, W = a.shape
    if B > 65535:
        raise ValueError(f"rglru_scan_fwd: batch {B} > 65535")
    out = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    if B * S * W:
        _launch("rglru_scan_fwd", False, a, (a, b), h0, (out,), None,
                plan or launch_plan(a))
        launches.add()
    return out


def rglru_scan_bwd(a, h, h0, dh, *, plan=None):
    """Gradients ``(da, db, dh0)`` of :func:`rglru_scan_fwd` for the
    cotangent ``dh``, from the saved ``a``, output ``h`` and ``h0``.

    One launch of the kernel in reverse: ``g = db`` solves ``g_t = dh_t +
    a_{t+1} g_{t+1}`` (``g_{S-1} = dh_{S-1}``) in f32, then ``da_t = g_t
    h_{t-1}`` (``h_{-1} = h0``) and ``dh0 = a_0 g_0`` from the f32 g,
    returned in the dtypes of a, a and h0.  dh and h are read in a's dtype
    (cast if they are not).  ``plan`` as in :func:`rglru_scan_fwd`."""
    _check("rglru_scan_bwd", a, (("a", a), ("h0", h0)))
    for name, t in (("h", h), ("dh", dh)):
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"rglru_scan_bwd: {name} must be on {a.device} (CUDA)")
    if a.dtype not in DTYPE_CODES or h0.dtype not in DTYPE_CODES:
        raise TypeError(f"rglru_scan_bwd: dtypes a={a.dtype} h0={h0.dtype} not supported")
    if a.dim() != 3 or h.shape != a.shape or dh.shape != a.shape or \
            h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan_bwd: shapes a {tuple(a.shape)}, h {tuple(h.shape)}, "
                         f"h0 {tuple(h0.shape)}, dh {tuple(dh.shape)}")
    h, dh = (t if t.dtype == a.dtype and t.stride(-1) == 1 else t.to(a.dtype).contiguous()
             for t in (h, dh))
    B, S, W = a.shape
    if B > 65535:
        raise ValueError(f"rglru_scan_bwd: batch {B} > 65535")
    da = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    db = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    dh0 = torch.empty((B, W), dtype=h0.dtype, device=a.device)
    if B * S * W:
        _launch("rglru_scan_bwd", True, a, (a, dh, h), h0, (da, db), dh0,
                plan or launch_plan(a, True))
        bwd_launches.add()
    else:
        dh0.zero_()
    return da, db, dh0
