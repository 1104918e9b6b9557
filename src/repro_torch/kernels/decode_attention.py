"""Decode-attention kernels (CUDA C++, ``csrc/decode_attention.cu``).

Replace the Pallas TPU kernels of ``repro/kernels/decode_attention.py``:

* :func:`decode_attention_fwd` (``pallas_call`` at :88, ``_kernel`` at
  :26): one token against a ring cache.  The model passes (B, NKV, S, D)
  transposed views of its (B, S, NKV, HD) ring cache.
* :func:`decode_attention_paged_fwd` (``pallas_call`` at :207,
  ``_paged_kernel`` at :111): one token against a shared page pool through
  per-row page tables (the continuous tier).  The model passes
  (P, NKV, page, D) transposed views of its (P, page, NKV, HD) pool.

The source file's header states what bounds them on the H100 and what
their design does about that.  The wrappers keep the JAX kernels' layouts
and signatures; caches and pools are read through strides, so no step
copies them.  Each wrapper has its own launch counter.

Both kernels split each row's keys into chunks across blocks;
:func:`split_plan` picks the chunking from the shape and the card's SM
count, so that the grid fills at least one wave.  The ring's chunks cut its
slot range; the pool's cut the row's live span, which each block works out
from ``pos`` on the device (:func:`paged_chunks` is the same arithmetic in
Python), so the paged wrapper never reads ``pos`` on the host; its plan
(:func:`paged_plan`) fills one resident wave of the card.  A block
scores its chunk ``MAX_CHUNK`` keys at a time and carries its softmax state
from step to step, so S has no cap.  Each chunk writes f32 partials (m, l,
acc) to scratch allocated here; the last block of each (row, kv head, head
group) merges them in chunk order (bitwise the same from run to run).  The
blocks find the last one through a ticket counter that the kernel leaves
at zero, kept here per (device, stream) and shared by both kernels.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable

import torch

from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.cuda_build import check_launch, library
from repro_torch.kernels.flash_attention import DTYPE_CODES, HEAD_DIMS, check_16b

__all__ = ["decode_attention_fwd", "decode_attention_paged_fwd", "split_plan",
           "paged_plan", "paged_launch_plan", "paged_chunks", "launches", "paged_launches"]

launches = LaunchCounter("decode_attention_fwd")
paged_launches = LaunchCounter("decode_attention_paged_fwd")

# The kernel's limits (csrc/decode_attention.cu, namespace split).
HEADS_PER_BLOCK = (16, 8, 4)  # query heads a block may hold, widest first
MAX_CHUNK = 256  # keys a block scores at a time (kStep); a longer chunk takes steps
MAX_SPLIT = 256  # chunks per row
MIN_CHUNK = 16  # fewer keys per block and the partials outweigh the cache


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _chunks(blocks: int, S: int, sm_count: int):
    """``(n_split, chunk)`` for ``blocks`` blocks per chunk index: the
    fewest chunks that make ``n_split * blocks`` reach ``sm_count`` (one
    wave) where S allows, with at most ``MAX_CHUNK`` keys each up to
    ``MAX_CHUNK * MAX_SPLIT`` keys; past that ``MAX_SPLIT`` longer chunks."""
    want = min(max(_cdiv(sm_count, blocks), _cdiv(S, MAX_CHUNK)), S, MAX_SPLIT)
    chunk = _cdiv(S, want)
    while chunk > 1 and _cdiv(S, chunk) < want:
        chunk -= 1
    return _cdiv(S, chunk), chunk


def split_plan(B: int, NKV: int, G: int, S: int, sm_count: int):
    """``(heads, n_split, chunk)`` of the ring kernel: each block holds
    ``heads`` query heads of one kv head (the group of ``G`` in
    ``ceil(G / heads)`` blocks) and one of ``n_split`` chunks of ``chunk``
    slots (the last one shorter, none empty); the grid of ``n_split * B *
    NKV * ceil(G / heads)`` blocks reaches ``sm_count`` where S allows.
    The widest ``heads`` (no wider than G needs) whose chunks keep at least
    ``MIN_CHUNK`` keys wins, else the narrowest: a chunk's f32 partials are
    ``heads * D`` floats, so tiny chunks of many heads write more than
    the cache holds, and the merge reads it all back.  Any S: past
    ``MAX_CHUNK * MAX_SPLIT`` slots the chunks grow and a block walks its
    chunk in steps of ``MAX_CHUNK``."""
    if min(B, NKV, G, S, sm_count) < 1:
        raise ValueError(f"split_plan: B={B} NKV={NKV} G={G} S={S} sm_count={sm_count}")
    widths = [h for h in HEADS_PER_BLOCK if h < 2 * G] or [HEADS_PER_BLOCK[-1]]
    for heads in widths:
        n_split, chunk = _chunks(B * NKV * _cdiv(G, heads), S, sm_count)
        if chunk >= MIN_CHUNK:
            break
    return heads, n_split, chunk


def paged_plan(B: int, NKV: int, G: int, S: int, sm_count: int,
               blocks_per_sm: Callable[[int], int] = lambda heads: 1):
    """``(heads, n_split)`` of the paged kernel, from the shape alone (``S``
    = NB * page, the most a row can hold; never ``pos``).  The ring
    planner's head groups; then the most chunks that keep every block of
    the grid resident at once (``sm_count * blocks_per_sm(heads)`` blocks,
    the kernel's occupancy), with at least ``MIN_CHUNK`` of the S keys
    each, and never fewer than the ring planner's.  A decode step is a
    chain of dependent loads per block, so shorter chunks finish sooner as
    long as no block waits for a second wave.  Each row's live span is cut
    into ``n_split`` equal chunks on the device (:func:`paged_chunks`)."""
    heads, n_split, _ = split_plan(B, NKV, G, S, sm_count)
    groups = B * NKV * _cdiv(G, heads)
    resident = sm_count * blocks_per_sm(heads) // groups
    return heads, max(n_split, min(resident, _cdiv(S, MIN_CHUNK), MAX_SPLIT))


def paged_chunks(pos: int, window: int, S: int, n_split: int):
    """What each block of the paged kernel computes from ``pos`` on the
    device: ``([(start, length) of chunk c for c < n_split], masked)``.  The
    chunks cut the live span ``[max(0, pos - window + 1), pos + 1)`` of the
    ``S`` dense entries (no window when ``window`` is 0) into equal parts;
    those past the span have length <= 0.  An empty span (``pos < 0``, or a
    window past the entries) takes every entry instead, all masked
    (``masked``): the mean of v, as the plain version gives."""
    lo = max(0, pos - window + 1) if window > 0 else 0
    hi = min(pos + 1, S)
    masked = lo >= hi
    if masked:
        lo, hi = 0, S
    cs = _cdiv(hi - lo, n_split)
    return [(lo + c * cs, min(cs, hi - lo - c * cs)) for c in range(n_split)], masked


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS = {}
_TICKETS_LOCK = threading.Lock()


def _tickets(device, stream: int, n: int):
    """A zeroed int32 buffer of at least ``n`` tickets for this stream (the
    kernel leaves it at zero, so one serves every launch on the stream)."""
    key = (device.index, stream)
    with _TICKETS_LOCK:
        buf = _TICKETS.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
            _TICKETS[key] = buf
        return buf


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("decode_attention")
    lib.decode_attention_fwd.argtypes = [_P] * 9 + [_I] * 9 + [_L] * 13 + [_I, _F, _P]
    lib.decode_attention_fwd.restype = ctypes.c_int
    lib.decode_attention_paged_fwd.argtypes = [_P] * 9 + [_I] * 9 + [_L] * 13 + [_I, _F, _P]
    lib.decode_attention_paged_fwd.restype = ctypes.c_int
    lib.decode_attention_paged_blocks_per_sm.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.decode_attention_paged_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _paged_blocks_per_sm(index: int, dtype_code: int, D: int, heads: int) -> int:
    """How many blocks of the paged kernel one SM of device ``index`` holds
    at once (the CUDA occupancy of that instantiation)."""
    lib = _lib()
    n = _I(0)
    with torch.cuda.device(index):
        err = lib.decode_attention_paged_blocks_per_sm(dtype_code, D, heads, ctypes.byref(n))
    check_launch(lib, err, "decode_attention_paged_fwd (occupancy)")
    return max(1, n.value)


def paged_launch_plan(q, S: int):
    """What :func:`decode_attention_paged_fwd` launches for a CUDA q (B, NKV,
    G, D) over rows of ``S`` = NB * page entries: :func:`paged_plan` with
    q's card's SM count and the kernel's occupancy there."""
    B, NKV, G, D = q.shape
    index, code = q.device.index, DTYPE_CODES[q.dtype]
    return paged_plan(B, NKV, G, S, _sm_count(index),
                      lambda heads: _paged_blocks_per_sm(index, code, D, heads))


def _check_operands(what, q, k, v, index, pos, names):
    for name, t in zip(names, (q, k, v, index, pos)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} must be on {q.device} (CUDA)")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last dim")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: dtypes q={q.dtype} k={k.dtype} v={v.dtype} not supported")
    if index.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{what}: {names[3]} and pos must be int32")
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, NKV, G, D), got {tuple(q.shape)}")


def _check_head(D, window, scale, what):
    """Checks the head dim and window; returns the softmax scale."""
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"{what}: window must be >= 0")
    return D**-0.5 if scale is None else scale


def _scratch(q, heads: int, n_split: int):
    """f32 partials (B, NKV, n_split, G, D) and (B, NKV, n_split, G, 2), the
    stream and its ticket buffer, for one launch on q's device."""
    B, NKV, G, D = q.shape
    part_acc = torch.empty((B, NKV, n_split, G, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, NKV, n_split, G, 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _tickets(q.device, stream, B * NKV * _cdiv(G, heads))
    return part_acc, part_ml, stream, tickets


def decode_attention_fwd(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0,
                         scale=None):
    """q: (B, NKV, G, D); caches: (B, NKV, S, D); slot_pos: (B, S) int32
    (-1 = empty slot); pos: (B,) int32.  Returns (B, NKV, G, D) in q's
    dtype.  Feature dims (and slot_pos's slot dim) must be contiguous."""
    _check_operands("decode_attention_fwd", q, k_cache, v_cache, slot_pos, pos,
                    ("q", "k_cache", "v_cache", "slot_pos", "pos"))
    B, NKV, G, D = q.shape
    S = k_cache.shape[2]
    if k_cache.shape != (B, NKV, S, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention_fwd: cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if slot_pos.shape != (B, S) or pos.shape != (B,):
        raise ValueError(f"decode_attention_fwd: slot_pos {tuple(slot_pos.shape)} / "
                         f"pos {tuple(pos.shape)} do not match B={B}, S={S}")
    scale = _check_head(D, window, scale, "decode_attention_fwd")
    out = torch.empty((B, NKV, G, D), dtype=q.dtype, device=q.device)
    if B * NKV * G * S:
        for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("out", out)):
            check_16b("decode_attention_fwd", name, t)  # 16-byte vector loads
        heads, n_split, chunk = split_plan(B, NKV, G, S, _sm_count(q.device.index))
        lib = _lib()
        with torch.cuda.device(q.device):
            part_acc, part_ml, stream, tickets = _scratch(q, heads, n_split)
            err = lib.decode_attention_fwd(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                slot_pos.data_ptr(), pos.data_ptr(), out.data_ptr(),
                part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(), heads, n_split,
                chunk,
                DTYPE_CODES[q.dtype], B, NKV, G, S, D,
                *(q.stride(i) for i in range(3)),
                *(k_cache.stride(i) for i in range(3)),
                *(v_cache.stride(i) for i in range(3)),
                slot_pos.stride(0),
                *(out.stride(i) for i in range(3)),
                int(window), float(scale), stream,
            )
        check_launch(lib, err, "decode_attention_fwd")
        launches.add()
    return out


def decode_attention_paged_fwd(q, k_pool, v_pool, page_tables, pos, *, window: int = 0,
                               scale=None):
    """q: (B, NKV, G, D); pools: (P, NKV, page, D); page_tables: (B, NB) int32
    page ids in [0, P); pos: (B,) int32.  Returns (B, NKV, G, D) in q's
    dtype.  Dense index ``i`` of row ``b`` is ``pool[page_tables[b, i //
    page], :, i % page]`` and is valid iff ``i <= pos[b]`` (and ``i >
    pos[b] - window``).  Feature dims (and the tables' entry dim) must be
    contiguous.  ``pos`` is read on the device only (no host sync)."""
    _check_operands("decode_attention_paged_fwd", q, k_pool, v_pool, page_tables, pos,
                    ("q", "k_pool", "v_pool", "page_tables", "pos"))
    B, NKV, G, D = q.shape
    P, page = (k_pool.shape[0], k_pool.shape[2]) if k_pool.dim() == 4 else (0, 0)
    if k_pool.shape != (P, NKV, page, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"decode_attention_paged_fwd: pool shapes {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if page_tables.dim() != 2 or page_tables.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"decode_attention_paged_fwd: page_tables "
                         f"{tuple(page_tables.shape)} / pos {tuple(pos.shape)} do not "
                         f"match B={B}")
    NB = page_tables.shape[1]
    scale = _check_head(D, window, scale, "decode_attention_paged_fwd")
    out = torch.empty((B, NKV, G, D), dtype=q.dtype, device=q.device)
    if B * NKV * G * NB * page:
        for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("out", out)):
            check_16b("decode_attention_paged_fwd", name, t)  # 16-byte vector loads
        heads, n_split = paged_launch_plan(q, NB * page)
        lib = _lib()
        with torch.cuda.device(q.device):
            part_acc, part_ml, stream, tickets = _scratch(q, heads, n_split)
            err = lib.decode_attention_paged_fwd(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(), heads, n_split,
                DTYPE_CODES[q.dtype], B, NKV, G, NB, page, D,
                *(q.stride(i) for i in range(3)),
                *(k_pool.stride(i) for i in range(3)),
                *(v_pool.stride(i) for i in range(3)),
                page_tables.stride(0),
                *(out.stride(i) for i in range(3)),
                int(window), float(scale), stream,
            )
        check_launch(lib, err, "decode_attention_paged_fwd")
        paged_launches.add()
    return out
