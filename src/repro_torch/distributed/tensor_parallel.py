"""Tensor parallelism over the mesh's ``model`` axis: what GSPMD makes of
the JAX model's ``constrain`` calls, written out (Megatron's layout, and
Megatron's sequence parallelism under the ``RULES_*_SP`` tables).

Under :func:`~repro_torch.distributed.api.axis_rules` whose mesh is a
``DeviceMesh`` with a ``model`` axis of more than one rank,
:func:`context` gives the model that axis: its process group, this rank's
index on it and its size.  The model then runs on this rank's slices of
the weights that the rules split over ``model`` (``heads``, ``kv_heads``,
``ffn``, ``expert_ffn``, ``vocab``, ``lru``):

* an attention block computes this rank's q heads (:func:`local_heads`)
  and the kv heads they read, then multiplies by its rows of ``wo``;
* an MLP computes its columns of ``wi`` / ``wg`` and its rows of ``wo``;
* a MoE block routes every token on every rank (the router is whole) and
  runs its columns of each expert's FFN;
* an RG-LRU block runs its ``lru`` channels: its columns of ``wx`` / ``wy``
  / the conv / the decay and gate biases, its rows of ``wo`` and of the
  ``(w, w)`` gate weights, whose products are rank partial sums
  (:meth:`TensorParallel.reduce_columns`); the scan kernel runs on the
  rank's channels;
* an mLSTM block runs its heads (the ``lru`` columns of ``wq`` / ``wk`` /
  ``wv`` / ``wz``, its rows of ``wo``); the per-head gates ``wi`` / ``wf``
  / ``bi`` / ``bf`` are whole on every rank, which computes every head's
  gates;
* an sLSTM block runs its heads' channels (its ``lru`` columns of
  ``w{i,f,z,o}`` and ``b{g}``, its rows of ``wo_proj``, its channels of the
  ``c, n, h, m`` state); the block-diagonal recurrence ``r{g}`` is read
  whole (:func:`reads_whole`: storage splits its contracted ``dh``, not its
  heads) and the rank's heads sliced from it, so no collective runs inside
  the time loop;
* the loss takes its vocab columns of the head (:func:`vocab_xent`).

Heads need not split evenly (GSPMD pads them; this module gives each rank
a contiguous run of whole heads, :func:`local_heads`): where a head count
does not split over the axis, a rank reads the leaves that hold those heads
whole (:func:`reads_whole`: ``wq`` / ``wo`` for attention q heads, ``wk`` /
``wv`` for kv heads, every ``lru`` leaf of an xLSTM cell), shared into the
region, and cuts its heads' columns or rows from them.  A rank may hold no
head at all; it then contributes zeros to the region's sum.  Serving
gathers what is split by heads over the ranks padded to the largest count
(:meth:`TensorParallel.gather_heads`): a decode step's q rows, the mLSTM's
k / v and final state.  An sLSTM state stays stored as ``cache_axes`` split
it, even channel chunks; with heads that do not split, a step all-gathers
the chunks, each rank advances its heads' channels, and the ranks' new
channels are gathered over the heads before each rank keeps its chunk.

Serving (:func:`layout`: the rules' mesh as a prefill or decode step sees
it) splits the batch over the batch axes and a cache as the model's
``cache_axes`` say: a ring's slots over the tensor axis (``seq_kv``), so
each rank holds every kv head of its slot range, a recurrent state's
channels (``lru``: the RG-LRU's ``h`` / ``conv_tail``, the sLSTM's
``c, n, h, m``), and the mLSTM's ``(C, n)`` whole on every rank (each
decode step gathers the token's k / v over the heads and every rank
advances the whole state; a prefill gathers the rank's heads' final state
once).  :func:`shard_tree` cuts a whole tree into this rank's slices,
:func:`gather_tree` puts them back together.  A decode step's attention
runs the decode kernel over the rank's slots for every head and folds the
ranks' rows by their log-sum-exps (:meth:`TensorParallel.fold`).

Activations enter such a region through :meth:`TensorParallel.enter`
(identity forward, sum over the axis backward) and leave it through
:meth:`TensorParallel.leave` (sum forward, identity backward): Megatron's
``f`` and ``g``.  A tensor that every rank holds whole but reads inside
the region (``q_norm`` / ``k_norm``, a kv head shared by several ranks, a
tied table's head rows, a MoE's gates, the mLSTM's gates, the sLSTM's
recurrence) goes in through :meth:`TensorParallel.share`, so its gradient
is the sum of the ranks' parts and every rank holds the whole of it; the
weights read outside (the norms between blocks, the token lookup, the
router's logits) need no sum.  So every gradient a rank computes is
complete for the slice it was given.

Sequence parallelism: where the active rules map ``seq_act`` to the tensor
axis (``RULES_2D_SP`` / ``RULES_3D_SP``), a step that is not a decode step
(training, prefill) keeps the residual stream as this rank's rows of the
sequence, (B, ceil(S / size), D), from the embedding on
(:meth:`~TensorParallel.split`), and runs every norm between blocks on those
rows (their weights then go in through ``share``: each rank's gradient is
its rows' part).  A sequence that does not split is padded, as GSPMD pads
it: the last ranks' blocks end in zero rows, which stay zero through every
norm and residual add and have zero gradients.
``enter`` becomes an all-gather of the sequence with the padding dropped (a
padded reduce-scatter in the backward) and ``leave`` a reduce-scatter of it,
padded first (an all-gather in the backward), so every region (attention
with its whole-sequence rotary positions, ring writes and flash kernels; the
RG-LRU and xLSTM scans; a MoE block, whose router reads the gathered rows
through :meth:`~TensorParallel.gather`; the vocab head) sees exactly the S
rows of the sequence.  A decode step is unchanged (the JAX model constrains
it on ``seq``, not ``seq_act``).

Every collective is one ``torch.distributed`` call on the axis' group
(:func:`all_reduce`, :func:`all_gather`, :func:`reduce_scatter`; the
train step's over the batch axes too).  These plain calls run on CUDA
tensors over gloo as over NCCL; DTensor's functional collectives are not
used for them (on a gloo group they fault on CUDA tensors).

What raises ``ValueError`` is what the JAX package's placement refuses
(:func:`check_config`): a stored leaf (``param_axes``, or ``cache_axes``
when serving) whose dim on the tensor axis does not divide over it, e.g. an
RG-LRU width, an mLSTM width, ``d_model`` under an sLSTM, or attention
columns ``n_heads * head_dim`` that do not split evenly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from repro_torch.distributed.api import _entry_axes, active_rules, mesh_axes
from repro_torch.tree import tree_map

__all__ = ["TENSOR_AXIS", "VOCAB_SPLIT_MIN", "RECURRENCE_LEAVES", "Heads", "TensorParallel",
           "Layout", "context", "layout", "data_ranks", "head_range", "local_heads",
           "check_config",
           "reads_whole", "vocab_range",
           "vocab_xent", "all_reduce", "all_gather", "reduce_scatter", "gather", "local_slice",
           "local_shape", "gather_axes", "shard_tree", "gather_tree"]

TENSOR_AXIS = "model"
# The head is split on ``vocab`` from this size up; hubert's 504-entry
# classification head stays whole (``transformer._model_axes``).
VOCAB_SPLIT_MIN = 1024
# The sLSTM recurrence ``r{g}`` (NH, dh, dh): the JAX package lays it out on
# ``lru`` at its contracted dh (``models/xlstm.py``), so a rank's stored
# slice is not its heads' recurrence and the model reads it whole.
RECURRENCE_LEAVES = ("ri", "rf", "rz", "ro")


@dataclasses.dataclass(frozen=True)
class Heads:
    """A rank's attention heads: q heads ``q0 .. q0 + nq``, kv heads ``kv0 ..
    kv0 + nkv`` (the ones those q heads read); ``kv_split``: the kv heads
    are split over the ranks as storage splits them (else the rank cuts its
    kv heads from the whole ``wk`` / ``wv``); ``expand``: the rank's q heads
    are not whole groups of its kv heads (they span two or more kv heads,
    the first or last group cut), so the kernel gets each q head's kv head
    repeated for it (one q head per kv head) and its backward sums the
    repeats' gradients."""

    q0: int
    nq: int
    kv0: int
    nkv: int
    kv_split: bool
    expand: bool = False

    def kv_index(self, group: int):
        """Per q head of the rank, the index of its kv head among ``kv0 ..
        kv0 + nkv`` (``group``: q heads per kv head in the model)."""
        return [(self.q0 + i) // group - self.kv0 for i in range(self.nq)]


def head_range(n: int, rank: int, size: int):
    """``(start, count)``: rank ``rank``'s contiguous share of ``n`` heads
    over ``size`` ranks, balanced: the first ``n % size`` ranks take one
    more (10 heads over 4 ranks: 3 / 3 / 2 / 2; 2 over 4: 1 / 1 / 0 / 0)."""
    base, rem = divmod(n, size)
    return rank * base + min(rank, rem), base + (rank < rem)


def local_heads(cfg, rank: int, size: int) -> Heads:
    """The q heads and kv heads that rank ``rank`` of ``size`` computes.  The
    q heads split as :func:`head_range` says (balanced, not GSPMD's padded
    blocks of ``ceil(n / size)``, which would leave the last rank 1 of 10);
    with kv heads that split over the ranks each rank's q heads are whole
    groups of its kv heads (storage's slices); otherwise each rank reads
    the kv heads its q heads do, which may be fewer than one per rank or
    span two groups (``expand``).  A rank may get no head."""
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    group = nq // nkv
    q0, n = head_range(nq, rank, size)
    if nkv % size == 0:
        per = nkv // size
        return Heads(q0, n, rank * per, per, True)
    if n == 0:
        return Heads(q0, 0, min(q0 // group, nkv), 0, False)
    kv0, kv1 = q0 // group, (q0 + n - 1) // group + 1
    return Heads(q0, n, kv0, kv1 - kv0, False,
                 kv1 - kv0 > 1 and bool(q0 % group or n % group))


def _tensor_logical(table) -> frozenset:
    """The logical axes that ``table`` maps onto the tensor axis."""
    return frozenset(ax for ax, e in table.items() if TENSOR_AXIS in _entry_axes(e))


def check_config(cfg, size: int, cache=None) -> None:
    """Raise ``ValueError`` where the tensor axis of ``size`` ranks cannot
    hold ``cfg``'s storage: a leaf of ``param_axes`` (and, with ``cache`` =
    ``(batch, max_len)``, of ``cache_axes``) whose dim on the tensor axis
    does not divide over it (the logical axes the active rules, else
    ``RULES_2D``, map onto it), as the JAX package's placement refuses it
    ("does not evenly divide").  Everything else splits: attention heads,
    kv heads and xLSTM heads that do not split over the ranks (or are fewer
    than them) are read whole and cut by rank (:func:`local_heads`), and a
    sequence under sequence parallelism is padded."""
    from repro_torch.distributed import api
    from repro_torch.models import transformer  # which imports this module

    rules = active_rules()
    on_axis = _tensor_logical(api.RULES_2D if rules is None else rules.table)

    def leaf(path, shape, axes):
        for d, (n, ax) in enumerate(zip(shape, axes)):
            if ax in on_axis and n % size:
                raise ValueError(
                    f"{cfg.name}: {'/'.join(path)} dim {d} ({ax}, {n}) does not evenly divide "
                    f"over {size} tensor-parallel ranks (its storage cannot be split, as the JAX "
                    "package's placement refuses it)")

    transformer._walk_axes(transformer.model_spec(cfg), transformer._model_axes(cfg), leaf)
    if cache is not None:
        whole = transformer._whole_cache(cfg, *cache, torch.device("meta"))
        transformer._walk_axes(tree_map(lambda t: tuple(t.shape), whole),
                               transformer.cache_axes(cfg), leaf, ("cache",))


def reads_whole(cfg, size: int):
    """A predicate over a leaf's path (its keys, the leaf's name last) and
    logical axes: whether a rank reads the leaf whole although storage may
    split it over the tensor axis.  So are the attention leaves of heads
    that do not split over the ranks (``heads``: ``wq`` / ``wo``;
    ``kv_heads``: ``wk`` / ``wv``, kv heads fewer than the ranks included),
    an xLSTM cell's ``lru`` leaves when its heads do not split, and the
    sLSTM recurrence (:data:`RECURRENCE_LEAVES`, split on its contracted
    ``dh``); every other leaf is read as its storage says."""
    q, kv = cfg.n_heads % size != 0, cfg.n_kv_heads % size != 0
    xl = bool(cfg.xlstm_heads) and cfg.xlstm_heads % size != 0

    def whole(path, axes) -> bool:
        if path[-1] in RECURRENCE_LEAVES:
            return True
        if "kv_heads" in axes:
            return kv
        if "heads" in axes:
            return q
        return xl and "lru" in axes and len(path) > 1 and path[-2] == "cell"

    return whole


def vocab_range(vocab: int, rank: int, size: int):
    """``(v0, v1)``: the vocab entries of rank ``rank``'s head columns, the
    chunk a DTensor ``Shard`` gives it (``torch.chunk``: ceil-sized)."""
    per = -(-vocab // size)
    return min(rank * per, vocab), min((rank + 1) * per, vocab)


def all_reduce(t, group, op: str = "sum"):
    """A new tensor: ``t`` summed (or ``op="max"``) over ``group``'s ranks."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    return out


def all_gather(t, group, dim: int):
    """The ranks' ``t`` of ``group`` concatenated along ``dim`` (equal shapes)."""
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.detach().contiguous(), group=group)
    return out if dim == 0 else torch.cat(out.chunk(n), dim)


def reduce_scatter(t, group, dim: int):
    """This rank's chunk along ``dim`` of ``t`` summed over ``group``'s ranks
    (``dim`` must split evenly)."""
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(t.shape)} does not split over {n} ranks")
    rows = t if dim == 0 else torch.cat(t.chunk(n, dim))
    out = t.new_empty((rows.shape[0] // n, *rows.shape[1:]))
    dist.reduce_scatter_tensor(out, rows.detach().contiguous(), group=group)
    return out


def gather(x, dims=None):
    """The local tensor of the DTensor ``x`` gathered over the mesh dims in
    ``dims`` (every one when None) that shard it, minor to major, as
    :func:`all_gather` calls: ``x.full_tensor()`` without DTensor's
    functional collectives.  Each dim must split evenly."""
    mesh, placements = x.device_mesh, x.placements
    t = x.to_local()
    for i in reversed(range(mesh.ndim)):
        pl = placements[i]
        if isinstance(pl, Shard) and mesh.size(i) > 1 and (dims is None or i in dims):
            if x.shape[pl.dim] % mesh.size(i):
                raise ValueError(f"shape {tuple(x.shape)} dim {pl.dim} does not split evenly over "
                                 f"{mesh.size(i)} ranks")
            t = all_gather(t, mesh.get_group(i), pl.dim)
    return t


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.tp.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


# Sequence parallelism: the sequence is dim 1 of a (B, S, ...) activation;
# each rank holds ceil(S / size) rows of it, the last ranks' ending in zero
# padding where S does not split (``TensorParallel.block``).
class _SeqEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.unpad(all_gather(x, tp.group, 1))

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(ctx.tp.pad(g), ctx.tp.group, 1), None


class _SeqLeave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return reduce_scatter(tp.pad(x), tp.group, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.unpad(all_gather(g, ctx.tp.group, 1)), None


class _SeqSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.pad(x).narrow(1, *tp.block()).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.unpad(all_gather(g, ctx.tp.group, 1)), None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.unpad(all_gather(x, tp.group, 1))

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.pad(g).narrow(1, *ctx.tp.block()).contiguous(), None


class _ReduceColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return all_reduce(x, tp.group).chunk(tp.size, -1)[tp.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.tp.group, -1), None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The tensor axis as the model sees it: ``group``, this rank's index
    ``rank`` on it and its ``size``; under sequence parallelism ``seq_in``
    (a region's input is this rank's rows of the sequence: :meth:`enter`
    gathers them) and ``seq_out`` (its output is: :meth:`leave` scatters
    it), and ``seq_len``, the sequence's S (its rows before padding).  The
    flags are set together by :func:`context`; a region whose input is
    already whole (a MoE block, its rows gathered for the router) runs with
    ``seq_in`` off."""

    group: object
    rank: int
    size: int
    seq_in: bool = False
    seq_out: bool = False
    seq_len: Optional[int] = None

    @property
    def seq(self) -> bool:
        """Whether the residual stream between blocks is this rank's rows."""
        return self.seq_out

    def block(self):
        """``(start, length)`` of this rank's block of the padded sequence
        of ``seq_len`` rows (``ceil(seq_len / size)`` rows a rank; the last
        ranks' blocks end in padding, or are all padding)."""
        per = -(-self._len() // self.size)
        return self.rank * per, per

    def _len(self) -> int:
        if self.seq_len is None:
            raise ValueError("sequence parallelism needs the sequence's length (seq_len)")
        return self.seq_len

    def pad(self, x):
        """``x`` (B, seq_len, ...) with zero rows after it to ``size`` equal
        blocks (``x`` itself when the sequence splits)."""
        n = x.shape[1]
        extra = -(-n // self.size) * self.size - n
        if not extra:
            return x
        return torch.cat([x, x.new_zeros((x.shape[0], extra, *x.shape[2:]))], 1)

    def unpad(self, x):
        """The first ``seq_len`` rows of the padded sequence ``x`` (``x``
        itself when nothing was padded)."""
        n = self._len()
        return x if x.shape[1] == n else x[:, :n].contiguous()

    def heads(self, n: int) -> slice:
        """This rank's heads of ``n`` (:func:`head_range`)."""
        start, count = head_range(n, self.rank, self.size)
        return slice(start, start + count)

    def head_slices(self, p, n: int, width: int, cols=(), rows=()):
        """``p`` with, where ``n`` heads do not split over the axis, the
        leaves ``cols`` cut to this rank's heads' columns (the last dim) and
        ``rows`` to their rows (the first), ``width`` entries a head, each
        leaf read whole and shared (its gradient summed over the axis, so
        complete on every rank); ``p`` as given where the heads split
        (storage's slices are then the rank's heads)."""
        if n % self.size == 0:
            return p
        h = self.heads(n)
        cut = slice(h.start * width, h.stop * width)
        p = dict(p)
        for k in cols:
            p[k] = self.share(p[k])[..., cut]
        for k in rows:
            p[k] = self.share(p[k])[cut]
        return p

    def gather_heads(self, t, n: int, dim: int, width: int = 1):
        """Every rank's heads of ``n`` from each rank's ``t``, whose ``dim``
        holds its heads (:meth:`heads`), ``width`` entries each: one
        all-gather, each rank's part padded to the largest count first
        where the heads do not split; no gradient (serving)."""
        base, rem = divmod(n, self.size)
        if not rem:
            return all_gather(t, self.group, dim)
        dim %= t.dim()
        most = (base + 1) * width
        if t.shape[dim] < most:
            shape = list(t.shape)
            shape[dim] = most - t.shape[dim]
            t = torch.cat([t, t.new_zeros(shape)], dim)
        parts = all_gather(t, self.group, dim).split(most, dim)
        return torch.cat([part.narrow(dim, 0, head_range(n, r, self.size)[1] * width)
                          for r, part in enumerate(parts)], dim)

    def enter(self, x):
        """``x`` into a split region: identity, its gradient summed over the
        axis; under ``seq_in`` every rank's rows gathered (dim 1), the
        gradient reduce-scattered."""
        return (_SeqEnter if self.seq_in else _Enter).apply(x, self)

    def leave(self, x):
        """The ranks' partial ``x`` summed over the axis, its gradient as it
        is; under ``seq_out`` the sum reduce-scattered to this rank's rows
        (dim 1), the gradient gathered."""
        return (_SeqLeave if self.seq_out else _Leave).apply(x, self)

    def share(self, t):
        """A tensor every rank holds whole, read inside a split region:
        identity, its gradient summed over the axis."""
        return _Enter.apply(t, self)

    def sum(self, t):
        """The ranks' partial ``t`` summed over the axis (whole rows), its
        gradient as it is."""
        return _Leave.apply(t, self)

    def split(self, x):
        """This rank's rows (dim 1) of ``x``, which every rank holds whole;
        the gradient gathered, so every rank's gradient of ``x`` is whole."""
        return _SeqSplit.apply(x, self)

    def gather(self, x):
        """Every rank's rows (dim 1) of ``x``, for work every rank repeats on
        the whole sequence; the gradient's rows of this rank kept."""
        return _SeqGather.apply(x, self)

    def reduce_columns(self, x):
        """The ranks' partial products ``x`` (..., W) summed over the axis
        (one all-reduce) and this rank's ``W / size`` columns kept; the
        gradient gathers the ranks' column gradients."""
        return _ReduceColumns.apply(x, self)

    def fold(self, out, lse):
        """The attention of every rank's slots from each rank's rows over its
        own: ``out`` (..., D) and ``lse`` (...) (its log-sum-exp, -1e30 with
        no valid slot) -> (..., D) in ``out``'s dtype.  One all-reduce of
        the max of the ranks' log-sum-exps, one of the weighted rows beside
        their weights ``exp(lse - max)`` (exactly 0 for a rank with no valid
        slot), in f32 at least."""
        dt = torch.promote_types(torch.promote_types(out.dtype, lse.dtype), torch.float32)
        w = torch.exp(lse.to(dt) - all_reduce(lse, self.group, op="max").to(dt))[..., None]
        num = all_reduce(torch.cat([out.to(dt) * w, w], -1), self.group)
        return (num[..., :-1] / num[..., -1:]).to(out.dtype)

    def attention_inputs(self, cfg, p, x):
        """``(x, p, heads)`` for this rank's heads (:func:`local_heads`): the
        block input entered; ``p`` with this rank's q heads' ``wq`` columns
        and ``wo`` rows (storage's slices as given, or cut from the whole
        leaves, shared, where the q heads do not split), its kv heads' ``wk``
        / ``wv`` columns (cut the same way where the kv heads do not split),
        and the whole ``q_norm`` / ``k_norm`` shared."""
        h = local_heads(cfg, self.rank, self.size)
        hd = cfg.head_dim
        p = dict(self.head_slices(p, cfg.n_heads, hd, cols=("wq",), rows=("wo",)))
        if not h.kv_split:
            cols = slice(h.kv0 * hd, (h.kv0 + h.nkv) * hd)
            for key in ("wk", "wv"):
                p[key] = self.share(p[key])[:, cols]
        for key in ("q_norm", "k_norm"):
            if key in p:
                p[key] = self.share(p[key])
        return self.enter(x), p, h


def context(decode: bool = False, seq_len: Optional[int] = None) -> Optional[TensorParallel]:
    """The tensor axis of the active rules, or None: no rules, a mesh that
    is only a shape (the dry-run's), no ``model`` axis, or one of size 1.
    Sequence-parallel (``seq_in`` / ``seq_out``) where the rules map
    ``seq_act`` to the tensor axis, unless ``decode``; ``seq_len``: the
    sequence's length (rows before padding), which the sequence-parallel
    collectives need."""
    rules = active_rules()
    mesh = None if rules is None else rules.mesh
    if mesh is None or not hasattr(mesh, "get_group"):
        return None
    names, sizes = mesh_axes(mesh)
    if TENSOR_AXIS not in names or sizes[names.index(TENSOR_AXIS)] == 1:
        return None
    seq = not decode and TENSOR_AXIS in _entry_axes(rules.table.get("seq_act"))
    return TensorParallel(mesh.get_group(TENSOR_AXIS), mesh.get_local_rank(TENSOR_AXIS),
                          sizes[names.index(TENSOR_AXIS)], seq_in=seq, seq_out=seq,
                          seq_len=seq_len if seq else None)


def data_ranks(mesh, rules):
    """``(dims, size, rank)``: the mesh dims of the rules' batch axes, the
    ranks over them and this rank's index among those, major to minor."""
    names, sizes = mesh_axes(mesh)
    dims = [names.index(ax) for ax in _entry_axes(rules.table["batch"])]
    coord = mesh.get_coordinate()
    size, rank = 1, 0
    for d in dims:
        size *= sizes[d]
        rank = rank * sizes[d] + coord[d]
    return tuple(dims), size, rank


@dataclasses.dataclass(frozen=True)
class Layout:
    """The active rules' mesh as a serving step sees it: the tensor axis
    ``tp`` (None with one rank on it), the batch axes' mesh ``data_dims``,
    their ``data_size`` ranks and this rank's ``data_rank`` among them."""

    mesh: object
    tp: Optional[TensorParallel]
    data_dims: tuple
    data_size: int
    data_rank: int

    def local_rows(self, t):
        """This rank's rows of a global-batch tensor (the batch must split)."""
        if self.data_size == 1:
            return t
        if t.shape[0] % self.data_size:
            raise ValueError(f"batch {t.shape[0]} does not split over {self.data_size} ranks")
        per = t.shape[0] // self.data_size
        return t[self.data_rank * per:(self.data_rank + 1) * per]

    def gather_rows(self, t):
        """The global batch of every rank's rows ``t`` (:meth:`local_rows`' inverse)."""
        for d in reversed(self.data_dims):
            if self.mesh.size(d) > 1:
                t = all_gather(t, self.mesh.get_group(d), 0)
        return t


def _rules_mesh():
    rules = active_rules()
    mesh = None if rules is None else rules.mesh
    return (rules, mesh) if mesh is not None and hasattr(mesh, "get_group") else (None, None)


def layout() -> Optional[Layout]:
    """The serving layout of the active rules, or None: no rules, a mesh
    that is only a shape, or one rank on both the tensor and batch axes."""
    rules, mesh = _rules_mesh()
    if mesh is None:
        return None
    dims, size, rank = data_ranks(mesh, rules)
    tp = context()
    if tp is None and size == 1:
        return None
    return Layout(mesh, tp, dims, size, rank)


def _splits(axes, only=None):
    """``[(dim, ranks, index)]``: each tensor dim that the active rules'
    mesh splits for logical ``axes`` (over mesh axes in ``only`` when
    given), its rank count and this rank's chunk, major to minor."""
    rules, mesh = _rules_mesh()
    if mesh is None:
        return []
    names, sizes = mesh_axes(mesh)
    coord = mesh.get_coordinate()
    out = []
    for dim, entry in enumerate(rules.spec(axes)):
        n, i = 1, 0
        for ax in _entry_axes(entry):
            if only is None or ax in only:
                j = names.index(ax)
                n, i = n * sizes[j], i * sizes[j] + coord[j]
        if n > 1:
            out.append((dim, n, i))
    return out


def local_shape(shape, axes):
    """The shape of this rank's slice of a whole tensor of ``shape`` laid
    out on logical ``axes`` by the active rules (each split dim even)."""
    shape = list(shape)
    for dim, n, _ in _splits(axes):
        if shape[dim] % n:
            raise ValueError(f"shape {tuple(shape)} dim {dim} ({axes[dim]}) does not split "
                             f"over {n} ranks")
        shape[dim] //= n
    return tuple(shape)


def local_slice(t, axes, only=None):
    """This rank's slice (a view) of the whole tensor ``t`` laid out on
    logical ``axes`` by the active rules; with ``only``, the split over
    those mesh axes alone."""
    for dim, n, i in _splits(axes, only):
        if t.shape[dim] % n:
            raise ValueError(f"shape {tuple(t.shape)} dim {dim} ({axes[dim]}) does not split "
                             f"over {n} ranks")
        per = t.shape[dim] // n
        t = t.narrow(dim, i * per, per)
    return t


def gather_axes(t, axes):
    """The whole tensor from every rank's :func:`local_slice` ``t``: one
    all-gather per mesh axis that splits it, minor to major."""
    rules, mesh = _rules_mesh()
    if mesh is None:
        return t
    names, sizes = mesh_axes(mesh)
    for dim, entry in enumerate(rules.spec(axes)):
        for ax in reversed(_entry_axes(entry)):
            if sizes[names.index(ax)] > 1:
                t = all_gather(t, mesh.get_group(ax), dim)
    return t


def shard_tree(tree, axes):
    """Every leaf of ``tree`` cut to this rank's slice as ``axes`` (a tree of
    logical axes, e.g. the model's ``cache_axes``) and the active rules say."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, axes[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_tree(v, a) for v, a in zip(tree, axes, strict=True))
    return local_slice(tree, axes)


def gather_tree(tree, axes):
    """:func:`shard_tree`'s inverse: every rank's slices gathered whole."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, axes[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather_tree(v, a) for v, a in zip(tree, axes, strict=True))
    return gather_axes(tree, axes)


def vocab_xent(logits, labels, v0: int, tp: TensorParallel):
    """``transformer._xent_chunk`` over vocab-split logits: ``logits`` (...,
    Vl) are entries ``v0 .. v0 + Vl`` of each row (every row on every
    rank).  The rows' max, sum of exps and target logit are reduced over
    the axis (the max alone, its gradient being nil; the two sums in one
    call through ``sum``).
    Returns the summed negative log-likelihood of the valid labels (>= 0),
    in the logits' dtype, and their count, f32."""
    m = all_reduce(logits.detach().amax(-1), tp.group, op="max")
    shifted = logits - m[..., None]
    width = logits.shape[-1]
    valid = labels >= 0
    here = (labels >= v0) & (labels < v0 + width)
    picked = shifted.gather(-1, (labels - v0).clamp(0, width - 1)[..., None])[..., 0]
    sums = tp.sum(torch.stack([shifted.exp().sum(-1), torch.where(here, picked, 0.0)]))
    nll = sums[0].log() - sums[1]
    return (nll * valid).sum(), valid.sum().float()
