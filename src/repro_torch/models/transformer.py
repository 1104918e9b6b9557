"""Model assembly for the block stacks of the zoo: init, prefill, decode,
and the training loss.

Parameters are plain dicts of tensors built from *spec tables*
(``{name: shape}``) with the JAX package's tree: ``embed``, ``final_norm``,
optional ``head``, ``periods`` (one dict per pattern kind, every leaf
stacked over the ``n_periods`` repeats) and ``epilogue`` (the kinds beyond
the last full period, e.g. recurrentgemma's trailing (recurrent,
recurrent)).  PyTorch runs eagerly, so the stack is a Python loop over
periods instead of a scan.  Init follows the JAX recipe: norms 1 (0 under
``norm_offset``), the RG-LRU decay ``lamb`` 0.65, biases 0, everything else
truncated-normal; norms, decays and gate biases stay f32.

Caches keep the JAX layout, stacked over periods like the parameters.  An
attention layer has a ring buffer ``k``/``v`` (B, S, NKV, HD) plus
``slot_pos`` (B, S) absolute positions (-1 empty); a recurrent layer has
its state ``h`` (B, W) f32 and the conv tail ``conv_tail`` (B, K-1, W).
Unlike the JAX package, which returns new cache arrays, :func:`prefill`
fills a fresh cache and :func:`decode_step` updates it **in place** (the
ring slot ``pos[0] % S`` through ``index_copy_``, ``h`` and ``conv_tail``
through ``copy_``), then returns the same cache object.

The continuous-batching tier keeps the JAX package's block-paged layout:
per attention layer one physical pool ``kp``/``vp`` (P, page, NKV, HD)
shared by every row, each row owning a page table into it (page 0 is the
trash page inactive rows write into).  :func:`prefill_ragged` runs
right-padded prompts, :func:`graft_prefill_batch` copies their caches into
the rows' pages (one ``index_copy_`` per leaf into the flattened pool) and
:func:`paged_decode_step` scatters each row's new k/v into its page slot,
all in place.  Recurrent state is not paged: :func:`supports_paged_decode`
refuses the hybrid stacks, as in the JAX package.

Training: :func:`loss_fn` is the JAX package's chunked softmax-xent.  With
autograd recording, the norms, the prefill attention and the RG-LRU scan
run through the autograd Functions of :mod:`repro_torch.kernels.ops` (the
kernels on CUDA), ``cfg.remat`` checkpoints each period
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``) and
each loss chunk is checkpointed too, so no (B, S, vocab) logits tensor is
ever held for the backward pass.

Every block kind over token inputs is ported: attention (``attn``,
``local``), MoE (``moe``: attention plus :mod:`~repro_torch.models.moe`),
RG-LRU (``recurrent``) and xLSTM (``mlstm`` with its (C, n) state, ``slstm``
with its (c, n, h, m) state, both f32 and updated in place like the
RG-LRU's), and both input frontends of the JAX package: ``audio`` (hubert:
frame embeddings through ``frontend.proj``, a bidirectional encoder with
no decode step) and ``vision`` (paligemma: patch embeddings through
``frontend.proj``, scaled like the tokens and put before them, with
prefix-LM attention over the patches, whose length rides in
:class:`SeqContext` into the attention kernels).  Every stack that is served also trains: a MoE
block's load-balancing loss is summed over the stack in the reference's
order (the blocks of a period, then the periods, then the epilogue) and
:func:`loss_fn` adds ``0.01 *`` that sum to the cross-entropy.  Serving
does not sum it (a call with a cache), so a decode step costs what it did.

Serving on a mesh: under ``axis_rules(AxisRules(device_mesh, table))``
(``RULES_2D`` or ``RULES_2D_DEC``, the JAX package's ``build_cell``),
:func:`prefill` and :func:`decode_step` take DTensor (or whole) weights
and the global batch, run this rank's rows of it on this rank's heads
(attention and xLSTM), ``ffn`` / ``expert_ffn`` / ``lru`` channels and
vocab columns (:mod:`~repro_torch.distributed.tensor_parallel`), and
return the global logits; the cache is this rank's slice of
:func:`cache_axes`' layout: its rows, its slots of every ring (``seq_kv``,
every kv head), its channels of an RG-LRU or sLSTM state, and the whole
mLSTM state.  A decode step's attention gathers the new token's q and k /
v over the heads, writes the ring slot on its owning rank, runs the decode
kernel over the rank's slots with the log-sum-exp and folds the ranks'
rows (:func:`_attention_split_cache`); an mLSTM decode step gathers the
token's k / v over the heads and advances the whole state on every rank.

Sequence parallelism (rules that map ``seq_act`` to the tensor axis,
``RULES_2D_SP`` / ``RULES_3D_SP``): a training or prefill step keeps the
residual stream as this rank's rows of the sequence from the embedding on,
as the JAX model's ``constrain(x, "batch", "seq_act", None)`` after the
embedding and at every period boundary lays it out; every norm between
blocks runs on those rows, and each block's region gathers the sequence
on entry and reduce-scatters it on leaving (``enter`` / ``leave``).  A
decode step keeps whole rows, as the JAX model's ``seq`` constraint does.

``cfg.kv_cache_quant`` keeps the ring caches in int8 with an f32 scale per
(entry, kv head) (:func:`_kv_quant`: max-abs / 127, round half to even):
every prefill and decode write is quantised, and a decode step dequantises
the whole ring (plain PyTorch, as the reference has no kernel for it)
before the ring-decode kernel.  The paged tier excludes it, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.api import mesh_axes
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import layers, moe, rglru, xlstm
from repro_torch.models.attention import (
    decode_attention,
    flash_attention,
    paged_decode_attention,
)
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map

__all__ = [
    "check_supported",
    "model_spec",
    "param_axes",
    "cache_axes",
    "unreached_leaves",
    "init_params",
    "params_from_numpy",
    "numpy_to_torch",
    "params_to",
    "forward_hidden",
    "loss_fn",
    "init_cache",
    "prefill",
    "decode_step",
    "supports_paged_decode",
    "prefill_ragged",
    "init_paged_cache",
    "graft_prefill",
    "graft_prefill_batch",
    "prefill_cache_width",
    "paged_decode_step",
    "local_params",
    "split_reads",
    "SeqContext",
]

_KINDS = ("attn", "local", "moe", "recurrent", "mlstm", "slstm")
_ATTN_KINDS = ("attn", "local", "moe")


_FRONTENDS = ("none", "audio", "vision")


def check_supported(cfg: ModelConfig, device=None, decode: bool = False) -> None:
    """Raise ``NotImplementedError`` for a config outside the ported subset
    and, when ``device`` is a CUDA device, for a head dim that the attention
    kernels do not have (:data:`~repro_torch.kernels.flash_attention.HEAD_DIMS`),
    so such a model is refused before any weight is allocated and not at
    its first attention call.  The CPU's plain versions take any head dim.
    With ``decode`` (a decode cache, a decode step, a serving backend),
    raise ``ValueError`` for an encoder-only config (hubert), which has no
    decode step, as the JAX package's ``configs/shapes.skip_reason`` says."""
    kinds = tuple(cfg.pattern) + tuple(cfg.epilogue)
    bad = sorted({k for k in kinds if k not in _KINDS})
    if bad:
        raise NotImplementedError(f"{cfg.name}: block kinds {bad} are not ported yet")
    if cfg.frontend not in _FRONTENDS:
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r} "
                         f"(the configs know {_FRONTENDS})")
    if decode and cfg.encoder_only:
        raise ValueError(f"{cfg.name}: encoder-only architecture has no decode step "
                         "(no decode cache, no generation); run forward_hidden / loss_fn")
    if (device is not None and torch.device(device).type == "cuda"
            and any(k in _ATTN_KINDS for k in kinds) and cfg.head_dim not in HEAD_DIMS):
        raise NotImplementedError(
            f"{cfg.name}: head dim {cfg.head_dim} has no CUDA attention kernel (the flash "
            f"and decode kernels take {HEAD_DIMS}); use one of those or run on the CPU")


# ---------------------------------------------------------------------------
# Spec tables.
# ---------------------------------------------------------------------------
def _attn_spec(cfg: ModelConfig):
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    spec = {
        "wq": (d, nq * hd),
        "wk": (d, nkv * hd),
        "wv": (d, nkv * hd),
        "wo": (nq * hd, d),
    }
    if cfg.qk_norm:
        spec["q_norm"] = (hd,)
        spec["k_norm"] = (hd,)
    return spec


def block_spec(cfg: ModelConfig, kind: str):
    if kind not in _KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    d = cfg.d_model
    if kind == "mlstm":
        return {"ln1": (d,), "cell": xlstm.mlstm_init_spec(cfg)}
    if kind == "slstm":
        return {"ln1": (d,), "cell": xlstm.slstm_init_spec(cfg)}
    return {
        "ln1": (d,),
        **({"rec": rglru.rglru_init_spec(cfg)} if kind == "recurrent"
           else {"attn": _attn_spec(cfg)}),
        "ln2": (d,),
        **({"moe": moe.moe_init_spec(cfg)} if kind == "moe"
           else {"mlp": layers.mlp_init_spec(d, cfg.d_ff, cfg.mlp_type)}),
    }


def model_spec(cfg: ModelConfig):
    check_supported(cfg)
    d = cfg.d_model
    spec: Dict[str, Any] = {
        "embed": {"tokens": (cfg.vocab_size, d)},
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        spec["head"] = (d, cfg.vocab_size)
    if cfg.frontend != "none":
        spec["frontend"] = {"proj": (cfg.frontend_dim, d)}
    spec["periods"] = tuple(block_spec(cfg, k) for k in cfg.pattern)
    spec["epilogue"] = tuple(block_spec(cfg, k) for k in cfg.epilogue)
    return spec


# ---------------------------------------------------------------------------
# Logical axes (the sharding layer's names for each dim; the JAX package
# keeps them beside the shapes as ``(shape, axes)`` leaves, this package in
# tables of the same tree).
# ---------------------------------------------------------------------------
def _attn_axes(cfg: ModelConfig):
    axes = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qk_norm:
        axes["q_norm"] = (None,)
        axes["k_norm"] = (None,)
    return axes


def block_axes(cfg: ModelConfig, kind: str):
    """The logical axes of :func:`block_spec`'s leaves."""
    ln = ("embed",)
    if kind in ("mlstm", "slstm"):
        cell = xlstm.mlstm_init_axes(cfg) if kind == "mlstm" else xlstm.slstm_init_axes(cfg)
        return {"ln1": ln, "cell": cell}
    return {
        "ln1": ln,
        **({"rec": rglru.rglru_init_axes(cfg)} if kind == "recurrent"
           else {"attn": _attn_axes(cfg)}),
        "ln2": ln,
        **({"moe": moe.moe_init_axes(cfg)} if kind == "moe"
           else {"mlp": layers.mlp_init_axes(cfg.mlp_type)}),
    }


def _model_axes(cfg: ModelConfig):
    # The token table is replicated over the tensor axis and sharded on
    # d_model, so token gathers stay local; a tiny classification vocabulary
    # (hubert's 504) is replicated, as in the JAX package.
    axes: Dict[str, Any] = {"embed": {"tokens": (None, "embed")}, "final_norm": ("embed",)}
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab" if cfg.vocab_size >= tensor_parallel.VOCAB_SPLIT_MIN
                                  else None)
    if cfg.frontend != "none":
        axes["frontend"] = {"proj": (None, "embed")}
    axes["periods"] = tuple(block_axes(cfg, k) for k in cfg.pattern)
    axes["epilogue"] = tuple(block_axes(cfg, k) for k in cfg.epilogue)
    return axes


def _walk_axes(spec, axes, fn, path=()):
    """``fn(path, shape, axes)`` over the leaves of a spec and its axes
    table, which must have the same keys and one axis per dim."""
    if _is_leaf_spec(spec):
        if not (isinstance(axes, tuple) and len(axes) == len(spec)):
            raise ValueError(f"{'/'.join(path)}: axes {axes!r} for shape {spec}")
        return fn(path, spec, axes)
    if isinstance(spec, dict):
        if set(spec) != set(axes):
            raise ValueError(f"{'/'.join(path)}: axes keys {sorted(axes)} != {sorted(spec)}")
        return {k: _walk_axes(v, axes[k], fn, path + (k,)) for k, v in spec.items()}
    return tuple(_walk_axes(v, a, fn, path + (str(i),))
                 for i, (v, a) in enumerate(zip(spec, axes, strict=True)))


def param_axes(cfg: ModelConfig):
    """A tree like :func:`init_params`' with each leaf's logical axes (a
    tuple of names or None, one per dim); the stacked-period axis is None
    (unsharded)."""
    return _walk_axes(model_spec(cfg), _model_axes(cfg),
                      lambda path, _, ax: (None, *ax) if path[0] == "periods" else ax)


def unreached_leaves(cfg: ModelConfig) -> frozenset:
    """Paths (``named_leaves``') of the parameters that no input of ``cfg``
    reaches: an audio encoder's token embedding when its head is untied.
    ``jax.grad`` gives them zero gradients."""
    if cfg.frontend == "audio" and not cfg.tie_embeddings:
        return frozenset({"embed/tokens"})
    return frozenset()


def _is_leaf_spec(node) -> bool:
    return isinstance(node, tuple) and bool(node) and all(isinstance(s, int) for s in node)


def _walk_spec(spec, fn, path=()):  # fn(path, shape) -> leaf value
    if _is_leaf_spec(spec):
        return fn(path, spec)
    if isinstance(spec, dict):
        return {k: _walk_spec(v, fn, path + (k,)) for k, v in spec.items()}
    if isinstance(spec, tuple):
        return tuple(_walk_spec(v, fn, path + (str(i),)) for i, v in enumerate(spec))
    raise TypeError(f"bad spec node at {path}: {type(spec)}")


def _is_norm(name: str) -> bool:
    return name.startswith("ln") or name.endswith("_norm") or name == "final_norm"


def _fp32_leaf(name: str) -> bool:
    """Norms, gate biases and decays stay fp32 (the JAX package's list)."""
    return _is_norm(name) or name in ("lamb", "bi", "bf", "gate_a_b", "gate_x_b")


def _init_fill(name: str, norm_offset: bool) -> Optional[float]:
    """The constant a leaf starts at in the JAX package's ``_init_leaf``, or
    None for a truncated-normal leaf."""
    if _is_norm(name):
        return 0.0 if norm_offset else 1.0
    if name == "lamb":  # RG-LRU decay: a ~ 0.95 at sigmoid midpoint
        return 0.65
    if name == "bf":  # forget-gate bias: remember by default
        return 1.0
    if name.endswith("_b") or name in ("bi", "bz", "bo") or name.startswith("b"):
        return 0.0
    return None


def _leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    return torch.float32 if _fp32_leaf(name) else getattr(torch, cfg.dtype)


def _full_shape(cfg: ModelConfig, path, shape):
    return (cfg.n_periods, *shape) if path[0] == "periods" else tuple(shape)


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda"):
    """Seeded init with the JAX package's recipe (norms 1, or 0 under
    ``norm_offset``; ``lamb`` 0.65; biases 0; weights truncated-normal).
    Each leaf draws from its
    own generator seeded by ``generator``'s seed and the leaf's path, so a
    leaf's values do not depend on the order of the tree.  On ``"meta"``
    the leaves have their shapes and dtypes and no values."""
    dev = resolve_device(device)
    check_supported(cfg, dev)
    base = 0 if generator is None else generator.initial_seed()

    def init(path, shape):
        name = path[-1]
        full = _full_shape(cfg, path, shape)
        dtype = _leaf_dtype(cfg, name)
        if dev.type == "meta":
            return torch.empty(full, dtype=dtype, device=dev)
        fill = _init_fill(name, cfg.norm_offset)
        if fill is not None:
            return torch.full(full, fill, dtype=dtype, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed((base * 1_000_003 + zlib.crc32("/".join(path).encode())) % (2**63))
        return layers.truncated_normal_init(g, full, dtype, 1.0, dev)

    return _walk_spec(model_spec(cfg), init)


def numpy_to_torch(arr) -> torch.Tensor:
    """An owned CPU tensor of a numpy array (ml_dtypes bfloat16 included)."""
    arr = np.array(arr, copy=True, order="C")  # owned and writable
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(cfg: ModelConfig, tree, device="cuda"):
    """The weight bridge: the JAX package's ``init_params`` tree, mapped to
    numpy arrays (``jax.tree.map(np.asarray, params)``), as this package's
    parameters.  Same tree, same stacked-period leaves; shapes are checked
    against the spec and dtypes follow the config (norms, decays and gate
    biases f32)."""
    dev = resolve_device(device)
    check_supported(cfg, dev)

    def take(path, shape):
        node = tree
        for key in path:
            node = node[int(key)] if isinstance(node, (tuple, list)) else node[key]
        full = _full_shape(cfg, path, shape)
        if tuple(node.shape) != full:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(node.shape)} != {full}")
        return numpy_to_torch(node).to(device=dev, dtype=_leaf_dtype(cfg, path[-1]))

    return _walk_spec(model_spec(cfg), take)


def params_to(params, device):
    """A copy of a parameter (or cache) tree on ``device``."""
    dev = resolve_device(device)
    if isinstance(params, dict):
        return {k: params_to(v, dev) for k, v in params.items()}
    if isinstance(params, tuple):
        return tuple(params_to(v, dev) for v in params)
    return params.to(dev)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Block application.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SeqContext:
    positions: torch.Tensor  # (B, S) int32 absolute positions
    sin: torch.Tensor  # (B, S, head_dim // 2) rotary tables, computed once
    cos: torch.Tensor
    decode: bool = False
    # Block-paged decode (continuous batching): per-row page tables into a
    # shared physical KV pool.  None => the dense ring-buffer cache path.
    page_tables: Optional[torch.Tensor] = None  # (B, NB) int32 page ids
    page_size: int = 0
    # Prefix-LM (paligemma's image prefix): (B,) int32 lengths, or None.
    prefix_len: Optional[torch.Tensor] = None
    # The tensor axis (training on a mesh whose ``model`` axis is split):
    # each block runs this rank's heads / ffn / expert_ffn columns.  Carried
    # here, not read per block, so a period's recompute under remat (on
    # autograd's thread) sees it too.
    tp: Optional[tensor_parallel.TensorParallel] = None
    # Serving on a mesh (prefill or a ring decode step under the rules):
    # the batch axes' split, which a MoE block's token groups follow.
    layout: Optional[tensor_parallel.Layout] = None


def _norm(cfg, w, x, tp=None):
    """The block norm of ``x``; under sequence parallelism (``tp.seq``) x
    is this rank's rows, so the weight is shared (its gradient summed)."""
    if tp is not None and tp.seq:
        w = tp.share(w)
    return layers.rms_norm(x, w, eps=cfg.norm_eps, offset=cfg.norm_offset)


def _kv_quant(x):
    """(..., HD) -> int8 values and an f32 scale per (entry, head): the
    max-abs over HD / 127 (at least 1e-8), values rounded half to even and
    clipped to +-127.  The division by 127 is a product with f32(1 / 127),
    as XLA compiles the reference's (the two differ by an ulp on some
    inputs), so the codes are the jitted JAX package's bit for bit."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1) * (1.0 / 127.0), 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _kv_dequant(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def _qkv(cfg, p, x, ctx: SeqContext, nq: int):
    """q (B, S, nq, HD) and k / v (B, S, as many kv heads as ``wk`` / ``wv``
    hold, HD): projected, qk-normed where the config says, rotated."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    nkv = p["wk"].shape[-1] // hd  # none on a tensor-parallel rank with no head
    q = (x @ p["wq"]).reshape(B, S, nq, hd)
    k = (x @ p["wk"]).reshape(B, S, nkv, hd)
    v = (x @ p["wv"]).reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
    return layers.apply_rope(q, ctx.sin, ctx.cos), layers.apply_rope(k, ctx.sin, ctx.cos), v


def _attention(cfg, p, x, ctx: SeqContext, kind: str, cache):
    if ctx.tp is not None and cache is not None:
        return _attention_split_cache(cfg, p, x, ctx, kind, cache)
    hd, nq, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    if ctx.tp is not None:  # this rank's q heads and the kv heads they read
        x, p, heads = ctx.tp.attention_inputs(cfg, p, x)
        nq, nkv = heads.nq, heads.nkv
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, ctx, nq)
    if ctx.tp is not None and heads.expand:
        k, v = _per_q_head(cfg, heads, k, v)
    window = cfg.window if kind == "local" else 0

    if ctx.decode:
        assert cache is not None and S == 1
        pos = ctx.positions[:, 0]  # (B,)
        if ctx.page_tables is not None:
            # Block-paged decode: rows advance at independent positions,
            # each writing its new k/v into its own page slot of the shared
            # pool, in place.  Inactive rows carry pos=0 and an all-trash
            # table, so their (duplicate) writes land in the trash page.
            page = ctx.page_size
            tbl = ctx.page_tables
            p64 = pos.long()
            rows = torch.arange(B, device=pos.device)
            flat_idx = tbl[rows, p64 // page].long() * page + p64 % page  # (B,)
            P = cache["kp"].shape[0]
            cache["kp"].view(P * page, nkv, hd).index_copy_(0, flat_idx, k[:, 0])
            cache["vp"].view(P * page, nkv, hd).index_copy_(0, flat_idx, v[:, 0])
            out = paged_decode_attention(q, cache["kp"], cache["vp"], tbl, pos, window=window)
            return out.reshape(B, S, nq * hd) @ p["wo"]
        # Rows advance in lockstep: one shared ring slot, pos[0] % S, taken
        # on the device (no host sync) and written in place.
        slot = (pos[:1] % cache["k"].shape[1]).long()
        writes = _ring_writes(cfg, k, v)
        for key, t in writes.items():
            cache[key].index_copy_(1, slot, t)
        cache["slot_pos"].index_copy_(1, slot, pos[:, None].to(cache["slot_pos"].dtype))
        kc, vc = cache["k"], cache["v"]
        if cfg.kv_cache_quant:  # the whole ring, dequantised for the kernel
            kc = _kv_dequant(kc, cache["k_scale"], k.dtype)
            vc = _kv_dequant(vc, cache["v_scale"], v.dtype)
        out = decode_attention(q, kc, vc, cache["slot_pos"], pos, window=window)
    else:
        out = flash_attention(q, k, v, causal=cfg.causal, window=window,
                              prefix_len=ctx.prefix_len)
        if cache is not None:
            _prefill_ring(cfg, cache, k, v, ctx.positions, cache["k"].shape[1], 0)
    out = out.reshape(B, S, nq * hd) @ p["wo"]
    return out if ctx.tp is None else ctx.tp.leave(out)


def _per_q_head(cfg, heads, k, v):
    """k / v of a rank's kv heads repeated per q head (one q head per kv
    head), where its q heads are not whole groups of them (``expand``);
    the repeats' gradients sum in the index's backward."""
    idx = torch.tensor(heads.kv_index(cfg.n_heads // cfg.n_kv_heads), device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _prefill_ring(cfg, cache, k, v, positions, ring: int, lo: int):
    """The prefill's cache write: prompt positions 0..S-1 land in one or two
    static slices of a ring of ``ring`` slots (the tail of the prompt if S
    > ring); ``cache`` holds the ring's slots ``lo .. lo + its length``
    (all of them on one rank), which take their part of each slice."""
    S = k.shape[1]
    keep = min(S, ring)
    start = S - keep
    slot0 = start % ring
    first = min(keep, ring - slot0)
    writes = _ring_writes(cfg, k, v)
    writes["slot_pos"] = positions.to(cache["slot_pos"].dtype)
    hi = lo + cache["slot_pos"].shape[1]
    # (first slot, first prompt index, length): the slice, then the wrapped remainder.
    for a, t0, n in ((slot0, start, first), (0, start + first, keep - first)):
        g0, g1 = max(a, lo), min(a + n, hi)
        if g0 < g1:
            for key, t in writes.items():
                cache[key][:, g0 - lo:g1 - lo] = t[:, t0 + g0 - a:t0 + g1 - a]


def _attention_split_cache(cfg, p, x, ctx: SeqContext, kind: str, cache):
    """Attention with a cache on the split tensor axis: this rank's q heads
    (:func:`tensor_parallel.local_heads`), the ring's slots split over the
    ranks (``seq_kv``), every kv head in each rank's slots.

    Prefill: the flash kernel on the rank's q heads and the kv heads they
    read (as training runs them); the prompt's k / v gathered over the kv
    heads (each rank computes every kv head when they do not split), and
    each rank writes its slots' part of the ring's slices.  Decode: the
    token's q gathered over the heads (padded to the largest count where
    they do not split: one all-gather of a few rows, where each rank
    computing every head's q would read all of ``wq``) and its k / v over
    the kv heads; the slot ``pos % ring`` written by its owner alone (a
    select on the device, no host read); the decode kernel over the rank's
    slots for every head, with its log-sum-exp; the ranks' rows folded
    (:meth:`TensorParallel.fold`); the rank's heads into its rows of
    ``wo``."""
    tp = ctx.tp
    if tp.seq:  # a prefill's rows of the sequence, gathered
        x = tp.enter(x)
    B, S, _ = x.shape
    h = tensor_parallel.local_heads(cfg, tp.rank, tp.size)
    p = tp.head_slices(p, cfg.n_heads, cfg.head_dim, cols=("wq",), rows=("wo",))
    q, k, v = _qkv(cfg, p, x, ctx, h.nq)  # k / v: the rank's kv heads, or every one
    window = cfg.window if kind == "local" else 0
    if h.kv_split:
        k_all, v_all = (tensor_parallel.all_gather(t, tp.group, 2) for t in (k, v))
    else:
        k_all, v_all = k, v
        k, v = (t[:, :, h.kv0:h.kv0 + h.nkv] for t in (k_all, v_all))
    lo, n = tp.rank * cache["k"].shape[1], cache["k"].shape[1]
    ring = n * tp.size
    if not ctx.decode:
        if h.expand:
            k, v = _per_q_head(cfg, h, k, v)
        out = flash_attention(q, k, v, causal=cfg.causal, window=window,
                              prefix_len=ctx.prefix_len)
        _prefill_ring(cfg, cache, k_all, v_all, ctx.positions, ring, lo)
    else:
        pos = ctx.positions[:, 0]
        slot = (pos[:1] % ring).long() - lo  # (1,): this rank's index of the slot
        mine = (slot >= 0) & (slot < n)
        slot = slot.clamp(0, n - 1)
        writes = _ring_writes(cfg, k_all, v_all)
        writes["slot_pos"] = pos[:, None]
        for key, t in writes.items():
            c = cache[key]
            keep = c.index_select(1, slot)
            c.index_copy_(1, slot, torch.where(mine.view((1,) * c.dim()), t.to(c.dtype), keep))
        kc, vc = cache["k"], cache["v"]
        if cfg.kv_cache_quant:
            kc = _kv_dequant(kc, cache["k_scale"], k.dtype)
            vc = _kv_dequant(vc, cache["v_scale"], v.dtype)
        out, lse = decode_attention(tp.gather_heads(q, cfg.n_heads, 2), kc, vc,
                                    cache["slot_pos"], pos, window=window, return_lse=True)
        out = tp.fold(out, lse[:, None])[:, :, h.q0:h.q0 + h.nq]
    return tp.leave(out.reshape(B, S, h.nq * cfg.head_dim) @ p["wo"])


def _ring_writes(cfg, k, v):
    """What a ring cache stores of new keys and values, by cache leaf:
    ``k`` / ``v`` as they are, or int8 with their ``k_scale`` /
    ``v_scale`` under ``cfg.kv_cache_quant``."""
    if not cfg.kv_cache_quant:
        return {"k": k, "v": v}
    (kq, ks), (vq, vs) = _kv_quant(k), _kv_quant(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _recurrent(cfg, p, x, ctx: SeqContext, cache):
    """The RG-LRU branch; a cache's ``h`` and ``conv_tail`` are updated in
    place (prefill seeds them, each decode step advances them)."""
    if ctx.decode:
        y, new = rglru.rglru_decode_step(cfg, p, x, cache, tp=ctx.tp)
    else:
        h0 = cache["h"] if cache is not None else None
        tail = cache["conv_tail"] if cache is not None else None
        y, (h_last, new_tail) = rglru.rglru_apply(cfg, p, x, h0=h0, conv_tail=tail, tp=ctx.tp)
        new = {"h": h_last, "conv_tail": new_tail}
    if cache is not None:
        cache["h"].copy_(new["h"])
        cache["conv_tail"].copy_(new["conv_tail"])
    return y


def _xlstm_cell(cfg, kind, p, x, ctx: SeqContext, cache):
    """An mLSTM or sLSTM cell; a cache's state leaves are updated in place
    (prefill seeds them, each decode step advances them).  On a split
    tensor axis the mLSTM state is whole on every rank (``cache_axes``): a
    prefill runs the rank's heads from their slice of it and gathers their
    final state over the heads."""
    tp = ctx.tp
    if kind == "mlstm":
        if ctx.decode:
            y, new = xlstm.mlstm_decode_step(cfg, p, x, cache, tp=tp)
        else:
            carry = (cache["C"], cache["n"]) if cache is not None else None
            if carry is not None and tp is not None:
                carry = tuple(t[:, tp.heads(cfg.xlstm_heads)] for t in carry)
            y, (C, n) = xlstm.mlstm_apply(cfg, p, x, carry=carry, tp=tp)
            if cache is not None and tp is not None:
                C, n = (tp.gather_heads(t, cfg.xlstm_heads, 1) for t in (C, n))
            new = {"C": C, "n": n}
    elif ctx.decode:
        y, new = xlstm.slstm_decode_step(cfg, p, x, cache, tp=tp)
    else:
        y, new = xlstm.slstm_apply(cfg, p, x, state=cache, tp=tp)
    if cache is not None:
        for key, t in new.items():
            cache[key].copy_(t)
    return y


def _moe(cfg, p, x, ctx: SeqContext):
    """The MoE FFN.  Serving with the batch split over ``R`` data ranks, its
    token groups are the global batch's: ``moe_groups / R`` of them on each
    rank when they split (the rank's rows are whole groups), else every
    rank gathers the batch, routes every group and keeps its rows (the
    groups whole, as under ``RULES_2D_DEC``'s unsplit ``moe_groups``).
    Under sequence parallelism the router reads whole groups: the block
    takes every rank's rows of the sequence (``gather``) and its output
    leaves reduce-scattered to this rank's rows."""
    tp = ctx.tp
    if tp is not None and tp.seq:
        x, tp = tp.gather(x), dataclasses.replace(tp, seq_in=False)
    lay = ctx.layout
    if lay is None or lay.data_size == 1:
        return moe.moe_apply(cfg, p, x, tp)
    if cfg.moe_groups % lay.data_size == 0:
        local = dataclasses.replace(cfg, moe_groups=cfg.moe_groups // lay.data_size)
        return moe.moe_apply(local, p, x, tp)
    y, aux = moe.moe_apply(cfg, p, lay.gather_rows(x), tp)
    return lay.local_rows(y), aux


def apply_block(cfg, kind: str, p, x, ctx: SeqContext, cache):
    """Returns ``(x, cache, aux)``: the block's output, its cache (updated
    in place) and its load-balancing loss, an f32 scalar for a MoE block and
    None (zero) for the others."""
    if kind not in _KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h = _norm(cfg, p["ln1"], x, ctx.tp)
    if kind in ("mlstm", "slstm"):
        return x + _xlstm_cell(cfg, kind, p["cell"], h, ctx, cache), cache, None
    if kind == "recurrent":
        x = x + _recurrent(cfg, p["rec"], h, ctx, cache)
    else:
        x = x + _attention(cfg, p["attn"], h, ctx, kind, cache)
    h2 = _norm(cfg, p["ln2"], x, ctx.tp)
    if kind == "moe":
        y, aux = _moe(cfg, p["moe"], h2, ctx)
        return x + y, cache, aux
    return x + layers.mlp_apply(p["mlp"], h2, cfg.mlp_type, ctx.tp), cache, None


# ---------------------------------------------------------------------------
# Caches.
# ---------------------------------------------------------------------------
def _block_cache(cfg, kind, batch, max_len, dtype, device, lead=()):
    if kind == "recurrent":
        return rglru.rglru_init_cache(cfg, batch, dtype, device, lead)
    if kind in ("mlstm", "slstm"):  # f32 state (f64 for a float64 model)
        init = xlstm.mlstm_init_cache if kind == "mlstm" else xlstm.slstm_init_cache
        return init(cfg, batch, device, lead, dtype=torch.promote_types(dtype, torch.float32))
    sc = max_len if kind != "local" else min(cfg.window, max_len)
    shape = (*lead, batch, sc, cfg.n_kv_heads, cfg.head_dim)
    kv_dtype = torch.int8 if cfg.kv_cache_quant else dtype
    cache = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "slot_pos": torch.full((*lead, batch, sc), -1, dtype=torch.int32, device=device),
    }
    if cfg.kv_cache_quant:
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return cache


def _block_cache_axes(cfg, kind, stacked: bool):
    """Logical axes of :func:`_block_cache`'s leaves.  Ring caches shard
    their slots on the tensor axis (``seq_kv``): with few KV heads the
    cache, not the weights, is what decode memory holds."""
    pre = (None,) if stacked else ()
    if kind in _ATTN_KINDS:
        ax = {"k": pre + ("batch", "seq_kv", None, None),
              "v": pre + ("batch", "seq_kv", None, None),
              "slot_pos": pre + ("batch", "seq_kv")}
        if cfg.kv_cache_quant:
            ax["k_scale"] = pre + ("batch", "seq_kv", None)
            ax["v_scale"] = pre + ("batch", "seq_kv", None)
        return ax
    if kind == "recurrent":
        return {"h": pre + ("batch", "lru"), "conv_tail": pre + ("batch", None, "lru")}
    if kind == "mlstm":
        return {"C": pre + ("batch", None, None, None), "n": pre + ("batch", None, None)}
    if kind == "slstm":
        return {k: pre + ("batch", "lru") for k in ("c", "n", "h", "m")}
    raise ValueError(kind)


def cache_axes(cfg: ModelConfig):
    """Logical axes for :func:`init_cache`'s tree."""
    return {"periods": tuple(_block_cache_axes(cfg, k, stacked=True) for k in cfg.pattern),
            "epilogue": tuple(_block_cache_axes(cfg, k, stacked=False) for k in cfg.epilogue)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """An empty cache for ``batch`` rows of up to ``max_len`` positions.
    Under rules on a mesh (:func:`tensor_parallel.layout`) each leaf has
    this rank's shape of :func:`cache_axes`' layout: its rows of the batch,
    its slots of each ring (``seq_kv``), its channels of a recurrent state
    (``lru``)."""
    dev = resolve_device(device)
    check_supported(cfg, dev, decode=True)
    lay = tensor_parallel.layout()
    if lay is None:
        return _whole_cache(cfg, batch, max_len, dev)
    if lay.tp is not None:
        tensor_parallel.check_config(cfg, lay.tp.size, cache=(batch, max_len))

    def local(t, axes):  # empty slots hold position -1, everything else 0
        fill = -1 if t.dtype == torch.int32 else 0
        return torch.full(tensor_parallel.local_shape(t.shape, axes), fill, dtype=t.dtype,
                          device=dev)

    return tree_map(local, _whole_cache(cfg, batch, max_len, torch.device("meta")),
                    cache_axes(cfg))


def _whole_cache(cfg, batch, max_len, dev):
    dtype = getattr(torch, cfg.dtype)
    periods = tuple(
        _block_cache(cfg, k, batch, max_len, dtype, dev, lead=(cfg.n_periods,))
        for k in cfg.pattern
    )
    epilogue = tuple(_block_cache(cfg, k, batch, max_len, dtype, dev) for k in cfg.epilogue)
    return {"periods": periods, "epilogue": epilogue}


# ---------------------------------------------------------------------------
# Forward passes.
# ---------------------------------------------------------------------------
def _embed_inputs(cfg, params, batch_inputs):
    """-> (x (B, S, D), positions (B, S) int32, prefix_len (B,) int32 or None).

    ``audio``: x is ``frames @ frontend.proj``.  ``vision`` with
    ``patches`` (B, P, frontend_dim) in the batch (prefill, training; not
    a decode step): the patches' embeddings, scaled like the tokens', go
    before the tokens, and every row's first P positions are its prefix."""
    dtype = getattr(torch, cfg.dtype)
    if cfg.frontend == "audio":
        frames = batch_inputs["frames"]  # (B, S, frontend_dim)
        x = frames.to(dtype) @ params["frontend"]["proj"]
        B, S = x.shape[:2]
        return x, torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S), None
    tokens = batch_inputs["tokens"]
    x = params["embed"]["tokens"][tokens].to(dtype)
    # sqrt(d_model) rounded to the model dtype first, as in the JAX model.
    emb_scale = (torch.tensor(math.sqrt(cfg.d_model), dtype=dtype, device=x.device)
                 if cfg.emb_scale else None)
    if emb_scale is not None:
        x = x * emb_scale
    prefix_len = None
    if cfg.frontend == "vision" and "patches" in batch_inputs:
        patches = batch_inputs["patches"]  # (B, P, frontend_dim)
        pe = patches.to(dtype) @ params["frontend"]["proj"]
        if emb_scale is not None:
            pe = pe * emb_scale
        x = torch.cat([pe, x], dim=1)
        prefix_len = torch.full((x.shape[0],), patches.shape[1], dtype=torch.int32,
                                device=x.device)
    B, S = x.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, pos, prefix_len


def _unstack(tree, n: int):
    """The ``n`` per-period trees of a stacked-period tree, as views.  One
    ``unbind`` per leaf: its backward writes the stacked gradient once,
    where indexing each period would add a full-size zero-padded gradient
    per period."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _add_aux(total, aux):
    """``total + aux`` for block losses summed from an f32 zero, with None
    standing for that zero: ``0 + a`` is ``a`` exactly, so the sum is the
    reference's, and a stack without MoE blocks adds nothing."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _period(cfg, layer_params, x, ctx: SeqContext, layer_caches):
    """One period of the stack: one block per pattern kind.  Returns
    ``(x, aux)``, the period's blocks' losses summed in order."""
    aux = None
    for i, kind in enumerate(cfg.pattern):
        c = layer_caches[i] if layer_caches is not None else None
        x, _, a = apply_block(cfg, kind, layer_params[i], x, ctx, c)
        aux = _add_aux(aux, a)
    return x, aux


def _run_stack(cfg, params, x, ctx: SeqContext, cache=None):
    """The periods (in order) and the epilogue; caches are updated in place.
    With ``cfg.remat`` and autograd recording (training), each period is
    checkpointed: only its input is kept, and the backward pass runs it
    again.  Returns ``(x, aux)``: the load-balancing losses summed over the
    periods' sums, then the epilogue's blocks, or None when no block has one
    or when ``cache`` is given (serving does not need it)."""
    remat = cfg.remat and cache is None and not ctx.decode and torch.is_grad_enabled()
    collect = cache is None
    n = cfg.n_periods
    kinds = [_unstack(p, n) for p in params["periods"]]  # [kind][period]
    aux = None
    for li in range(n):
        lp = tuple(k[li] for k in kinds)
        if remat:
            x, a = checkpoint(_period, cfg, lp, x, ctx, None,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            lc = (tuple(_index(c, li) for c in cache["periods"]) if cache is not None
                  else None)
            x, a = _period(cfg, lp, x, ctx, lc)
        if collect:
            aux = _add_aux(aux, a)
    for i, kind in enumerate(cfg.epilogue):
        c = cache["epilogue"][i] if cache is not None else None
        x, _, a = apply_block(cfg, kind, params["epilogue"][i], x, ctx, c)
        if collect:
            aux = _add_aux(aux, a)
    return x, aux


def forward_hidden(cfg, params, batch_inputs, cache=None, decode=False, positions=None,
                   page_tables=None, page_size: int = 0):
    """``(x, cache, aux)``: final-normed hidden states (B, S, D), ``cache``
    (updated in place; with ``page_tables``, decode only, a paged pool) and
    the stack's load-balancing loss (an f32 scalar, or None: see
    :func:`_run_stack`).  Under sequence parallelism x is this rank's rows
    of the sequence, (B, ceil(S / size), D), zero-padded past S."""
    tp = tensor_parallel.context(decode=decode)
    if tp is not None and page_tables is not None:
        raise NotImplementedError(
            "the block-paged pool has no mesh axes (as in the JAX package): the continuous "
            "tier serves on one rank")
    x, pos, prefix_len = _embed_inputs(cfg, params, batch_inputs)
    if positions is not None:
        pos = positions
    sin, cos = layers.rope(pos, cfg.head_dim, cfg.rope_theta,
                           dtype=torch.promote_types(x.dtype, torch.float32))
    if tp is not None and tp.seq:  # the residual stream: this rank's rows
        tp = dataclasses.replace(tp, seq_len=x.shape[1])
        x = tp.split(x)
    ctx = SeqContext(positions=pos, sin=sin, cos=cos, decode=decode,
                     page_tables=page_tables, page_size=page_size, prefix_len=prefix_len, tp=tp,
                     layout=tensor_parallel.layout() if cache is not None else None)
    x, aux = _run_stack(cfg, params, x, ctx, cache=cache)
    return _norm(cfg, params["final_norm"], x, tp), cache, aux


def _seq_len(cfg, batch_inputs) -> int:
    """The length of the hidden sequence of ``batch_inputs`` (a vision
    model's patches before its tokens)."""
    if cfg.frontend == "audio":
        return batch_inputs["frames"].shape[1]
    n = batch_inputs["tokens"].shape[1]
    if cfg.frontend == "vision" and "patches" in batch_inputs:
        n += batch_inputs["patches"].shape[1]
    return n


def _head_weight(cfg, params):
    """The (D, V) head weight: the tied embedding's transpose, or ``head``."""
    return params["embed"]["tokens"].T if cfg.tie_embeddings else params["head"]


def _logits(x, w):
    """f32 logits (float64 for a float64 ``x``)."""
    y = x @ w.to(x.dtype)
    return y.to(torch.promote_types(y.dtype, torch.float32))


def _unembed(cfg, params, x):
    return _logits(x, _head_weight(cfg, params))


def _xent_chunk(x, w, labels, tp=None, v0=0):
    """Summed negative log-likelihood of one chunk's valid labels (>= 0)
    and their count, both f32.  With ``tp``, ``w`` is this rank's head
    columns, vocab entries ``v0`` on (:func:`tensor_parallel.vocab_xent`)."""
    if tp is not None:
        return tensor_parallel.vocab_xent(_logits(x, w), labels, v0, tp)
    lp = torch.log_softmax(_logits(x, w), dim=-1)
    valid = labels >= 0
    nll = -lp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return (nll * valid).sum(), valid.sum().float()


def loss_fn(cfg, params, batch):
    """Chunked softmax-xent.  ``batch``: the inputs (``tokens`` (B, S);
    ``frames`` for audio; ``patches`` beside the tokens for vision, whose
    hidden states then run P positions longer) and ``labels`` (B, S_out),
    aligned with the last S_out positions; labels < 0 are ignored (prefix /
    padding).  Returns
    ``(loss, metrics)`` with ``loss = xent + 0.01 * aux`` and the metrics
    ``xent``, ``aux`` (the stack's MoE load-balancing loss; 0 without MoE
    blocks) and ``tokens`` (valid labels), all f32, as the JAX package's
    ``loss_fn``.  Each ``cfg.loss_chunk`` slice of the sequence is
    checkpointed when autograd records, so the backward pass holds one
    chunk's logits at a time.  On a split tensor axis a head of
    ``VOCAB_SPLIT_MIN`` entries or more is split on the vocab: each rank
    scores its columns (a tied table's rows, the table shared whole) and
    the softmax's sums are reduced over the axis; under sequence
    parallelism the head reads the gathered rows."""
    x, _, aux = forward_hidden(cfg, params, batch)
    labels = batch["labels"].long()
    B, S = labels.shape
    tp, v0 = tensor_parallel.context(seq_len=_seq_len(cfg, batch)), 0
    split = tp is not None and cfg.vocab_size >= tensor_parallel.VOCAB_SPLIT_MIN
    if tp is not None and tp.seq:  # the head reads every row of the sequence
        x = tp.enter(x) if split else tp.gather(x)
    x = x[:, -S:]
    C = min(cfg.loss_chunk, S)
    while S % C:
        C -= 1
    if not split:
        tp = None  # a whole head: every rank scores every entry
        w = _head_weight(cfg, params)
    else:
        if not tp.seq:
            x = tp.enter(x)
        v0, v1 = tensor_parallel.vocab_range(cfg.vocab_size, tp.rank, tp.size)
        w = (tp.share(params["embed"]["tokens"])[v0:v1].T if cfg.tie_embeddings
             else params["head"])
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // C):
        xs, ls = x[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C]
        if torch.is_grad_enabled():
            t, c = checkpoint(_xent_chunk, xs, w, ls, tp, v0, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            t, c = _xent_chunk(xs, w, ls, tp, v0)
        tot = tot + t
        cnt = cnt + c
    xent = tot / cnt.clamp_min(1.0)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    loss = xent + 0.01 * aux
    return loss, {"xent": xent, "aux": aux, "tokens": cnt}


def local_params(cfg, params, mesh):
    """The weights the model reads on this rank of ``mesh``: each leaf whole
    over every mesh axis but the tensor axis, and there this rank's slice
    of a leaf the model reads split (:func:`param_axes` with
    :func:`tensor_parallel.reads_whole`: attention, kv and xLSTM heads that
    do not split over the ranks and the sLSTM recurrence are read whole).
    A DTensor leaf (placed on its sharding) is gathered; a plain tensor is
    taken as the whole leaf and cut (a view)."""
    names, sizes = mesh_axes(mesh)
    size = dict(zip(names, sizes)).get(tensor_parallel.TENSOR_AXIS, 1)
    model_dim = (names.index(tensor_parallel.TENSOR_AXIS)
                 if tensor_parallel.TENSOR_AXIS in names else None)

    def read(p, axes, split):
        if isinstance(p, DTensor):
            return tensor_parallel.gather(
                p, {i for i in range(len(names)) if not (split and i == model_dim)})
        return tensor_parallel.local_slice(p, axes, only=(tensor_parallel.TENSOR_AXIS,)) \
            if split else p

    with torch.no_grad():
        return tree_map(read, params, param_axes(cfg), split_reads(cfg, size))


def split_reads(cfg, size: int):
    """A tree like :func:`param_axes`' of bools: whether a rank of a tensor
    axis of ``size`` ranks reads the leaf as its storage splits it (False:
    whole, :func:`tensor_parallel.reads_whole`)."""
    whole = tensor_parallel.reads_whole(cfg, size)
    return _walk_axes(model_spec(cfg), _model_axes(cfg), lambda path, _, ax: not whole(path, ax))


def _serving(cfg, params, rows):
    """``(layout, params, rows)`` for a prefill or decode step: under rules
    on a mesh, this rank's weights (:func:`local_params`) and its rows of
    each global-batch tensor in ``rows``; else None and the inputs."""
    lay = tensor_parallel.layout()
    if lay is None:
        return None, params, rows
    return lay, local_params(cfg, params, lay.mesh), {k: lay.local_rows(v) for k, v in rows.items()}


def _serve_logits(cfg, params, x, lay):
    """f32 logits (B, S, V) of the hidden states ``x`` for every row of the
    global batch.  On a split tensor axis a head of ``VOCAB_SPLIT_MIN``
    entries or more is split on the vocab: each rank scores its columns (a
    tied table's rows) and the ranks' columns are gathered; the data ranks'
    rows are gathered."""
    tp = None if lay is None else lay.tp
    if tp is None or cfg.vocab_size < tensor_parallel.VOCAB_SPLIT_MIN:
        logits = _unembed(cfg, params, x)
    else:
        v0, v1 = tensor_parallel.vocab_range(cfg.vocab_size, tp.rank, tp.size)
        if (v1 - v0) * tp.size != cfg.vocab_size:
            raise ValueError(f"{cfg.name}: vocab {cfg.vocab_size} does not split evenly over "
                             f"{tp.size} tensor-parallel ranks")
        w = params["embed"]["tokens"][v0:v1].T if cfg.tie_embeddings else params["head"]
        logits = tensor_parallel.all_gather(_logits(x, w), tp.group, -1)
    return logits if lay is None else lay.gather_rows(logits)


def prefill(cfg, params, batch_inputs, max_len: int):
    """Run the prompt, returning (cache, last-position logits (B, V) f32).
    The prompt is ``tokens``, with ``patches`` before them for a vision
    model (the cache then holds P + S positions, and decode continues at
    position P + S), or ``frames`` for audio (refused: an encoder-only
    model has no decode cache).

    Under rules on a mesh (``axis_rules(AxisRules(device_mesh, table))``,
    the JAX package's ``build_cell`` prefill): ``params`` are DTensors on
    their shardings or whole tensors (:func:`local_params`), the prompt and
    the logits are the global batch, and the cache is this rank's slice of
    :func:`cache_axes`' layout (:func:`init_cache`), which
    :func:`tensor_parallel.gather_tree` puts back together."""
    tokens = batch_inputs.get("tokens", batch_inputs.get("frames"))
    lay, params, batch_inputs = _serving(cfg, params, batch_inputs)
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
    x, _, _ = forward_hidden(cfg, params, batch_inputs, cache=cache)
    if lay is not None and lay.tp is not None and lay.tp.seq:  # the last row, on its rank
        per = x.shape[1]
        r, j = divmod(_seq_len(cfg, batch_inputs) - 1, per)
        x = tensor_parallel.all_gather(x[:, j:j + 1], lay.tp.group, 1)[:, r:r + 1]
    else:
        x = x[:, -1:]
    return cache, _serve_logits(cfg, params, x, lay)[:, 0]


def decode_step(cfg, params, cache, token, pos):
    """One decode step.  token: (B,) int; pos: (B,) int32 positions.
    Returns (logits (B, V) f32, cache) — the same cache, updated in place.
    Under rules on a mesh, as :func:`prefill`: ``token``, ``pos`` and the
    logits the global batch, ``cache`` this rank's slice."""
    lay, params, rows = _serving(cfg, params, {"token": token, "pos": pos})
    x, _, _ = forward_hidden(
        cfg, params, {"tokens": rows["token"][:, None]}, cache=cache, decode=True,
        positions=rows["pos"][:, None],
    )
    return _serve_logits(cfg, params, x, lay)[:, 0], cache


# ---------------------------------------------------------------------------
# Block-paged decode (continuous batching).
# ---------------------------------------------------------------------------
def supports_paged_decode(cfg: ModelConfig) -> bool:
    """Whether the paged continuous-batching path can serve this config
    (the JAX package's predicate: a causal stack of attention and MoE blocks
    without KV quantization; recurrent and xLSTM state is not paged)."""
    kinds = tuple(cfg.pattern) + tuple(cfg.epilogue)
    return cfg.causal and not cfg.kv_cache_quant and all(k in _ATTN_KINDS for k in kinds)


def prefill_ragged(cfg, params, batch_inputs, lengths, max_len: int):
    """Prefill a right-padded batch with per-row prompt lengths.

    ``tokens`` is (B, S) right-padded, ``lengths`` (B,) each row's real
    prompt length; the logits (B, V) f32 are gathered at each row's last
    real position.  Causal masking makes the padding inert, so they equal
    the unpadded prefill's.  Cache entries past a row's length hold
    pad-token k/v that the paged mask never exposes.
    """
    tokens = batch_inputs["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    x, _, _ = forward_hidden(cfg, params, batch_inputs, cache=cache)
    idx = (lengths.long() - 1).clamp(0, S - 1)
    x_last = x[torch.arange(B, device=x.device), idx][:, None]  # (B, 1, D)
    return cache, _unembed(cfg, params, x_last)[:, 0]


def _paged_block_cache(cfg, kind, n_pages, page_size, dtype, device, lead=()):
    if kind not in _ATTN_KINDS:
        raise ValueError(f"paged decode supports attention blocks only, got {kind!r}")
    shape = (*lead, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "kp": torch.zeros(shape, dtype=dtype, device=device),
        "vp": torch.zeros(shape, dtype=dtype, device=device),
    }


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, device="cuda"):
    """Physical KV page pools for every attention layer (no batch dim:
    rows share the pool through their page tables), stacked over periods."""
    if not supports_paged_decode(cfg):
        raise ValueError(
            f"config {cfg.name!r} cannot use the paged decode path "
            "(needs a causal attention-only stack without kv quant)"
        )
    dev = resolve_device(device)
    check_supported(cfg, dev)
    dtype = getattr(torch, cfg.dtype)
    periods = tuple(
        _paged_block_cache(cfg, k, n_pages, page_size, dtype, dev, lead=(cfg.n_periods,))
        for k in cfg.pattern
    )
    epilogue = tuple(
        _paged_block_cache(cfg, k, n_pages, page_size, dtype, dev) for k in cfg.epilogue
    )
    return {"periods": periods, "epilogue": epilogue}


def _graft(paged_cache, prefill_cache, flat_idx, take):
    """Copies ``take(prefill leaf)`` (*lead, N, NKV, HD) into the flattened
    pools at ``flat_idx`` (N,), in place, for every k/v leaf."""
    for group in ("periods", "epilogue"):
        for pc, pf in zip(paged_cache[group], prefill_cache[group]):
            for pool, pre in ((pc["kp"], pf["k"]), (pc["vp"], pf["v"])):
                lead = pool.shape[:-4]
                P, page, nkv, hd = pool.shape[-4:]
                flat = pool.view(*lead, P * page, nkv, hd)
                flat.index_copy_(len(lead), flat_idx, take(pre, lead))
    return paged_cache


def graft_prefill(cfg, paged_cache, prefill_cache, row: int, page_table, page_size: int):
    """Copy one prefilled row's KV state into its slot's pages, in place.

    ``prefill_cache`` comes from :func:`prefill_ragged` over a cache of
    exactly the prompt width ``W`` (no ring wrap, so dense index ==
    absolute position).  All ``W`` positions scatter through
    ``page_table`` (NB,): positions past the row's reservation land in the
    trash page, pad positions are overwritten by decode before the mask
    exposes them.  Returns ``paged_cache``.
    """
    idx = torch.arange(prefill_cache_width(prefill_cache), device=page_table.device)
    flat_idx = page_table.long()[idx // page_size] * page_size + idx % page_size
    return _graft(paged_cache, prefill_cache, flat_idx,
                  lambda pre, lead: pre.select(len(lead), row))


def graft_prefill_batch(cfg, paged_cache, prefill_cache, page_tables, page_size: int):
    """Copy every prefilled row's KV state into its slot's pages at once.

    ``page_tables`` is (B, NB), one table per prefill row; all ``B * W``
    positions scatter in one ``index_copy_`` per leaf.  Padded ladder rows
    carry an all-trash table: their writes collapse into the trash page
    (overlapping writes there are harmless).  Returns ``paged_cache``.
    """
    idx = torch.arange(prefill_cache_width(prefill_cache), device=page_tables.device)
    flat_idx = (page_tables.long()[:, idx // page_size] * page_size
                + idx % page_size).reshape(-1)  # (B*W,)
    return _graft(paged_cache, prefill_cache, flat_idx,
                  lambda pre, lead: pre.reshape(*lead, -1, *pre.shape[-2:]))


def prefill_cache_width(prefill_cache) -> int:
    """Sequence width of a dense prefill cache (its ring length)."""
    for group in (prefill_cache["periods"], prefill_cache["epilogue"]):
        for layer in group:
            if "k" in layer:
                return layer["k"].shape[-3]
    raise ValueError("prefill cache has no attention layers")


def paged_decode_step(cfg, params, paged_cache, page_tables, token, pos, page_size: int):
    """One decode step over the shared page pool.

    token/pos: (B,) per-row tokens and int32 positions (rows need not be in
    lockstep); ``page_tables``: (B, NB) int32.  Inactive rows should carry
    pos=0 and an all-trash table.  Returns (logits (B, V) f32, paged_cache)
    with the pool updated in place.
    """
    x, _, _ = forward_hidden(
        cfg, params, {"tokens": token[:, None]}, cache=paged_cache, decode=True,
        positions=pos[:, None], page_tables=page_tables, page_size=page_size,
    )
    return _unembed(cfg, params, x)[:, 0], paged_cache
