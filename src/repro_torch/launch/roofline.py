"""Roofline terms of a step on the H100, the JAX package's
``launch/roofline.py`` on the card's terms.

Terms per (arch, shape, mesh), in seconds, from the H100 table of
``serving/profiles.py`` (data sheet: 989e12 bf16 FLOP/s, 3.35e12 B/s of
HBM, 450e9 B/s of NVLink per direction):

    compute    = FLOPs / 989e12
    memory     = bytes / 3.35e12
    collective = collective_bytes / 450e9

each per device.  The counts come from the counter of
:mod:`repro_torch.kernels.cost`, traced on meta tensors at a cell's global
shapes; per-device work is the global count divided by the chips, as the
JAX dry-run assumes (the rules balance the work up to padding).  As in the
JAX package, a step is counted as *cost components*, one block per layer
kind (forward, or forward and backward), the 0-layer ends (embedding,
final norm, logits / loss) and the optimizer, combined by their layer
counts.

The port has no partitioner whose program could be read, so collective
bytes are *reckoned from the rules* per component (:func:`reckon_collectives`),
in the JAX package's convention: the result-shape bytes per device of
each collective.  For a parameter ``W`` whose spec shards it over mesh
axes ``S_W``, with the batch over axes ``S_B`` and ``k(A)`` the product of
the sizes of axes ``A`` (a mesh axis of one rank is no axis: a collective
over it moves nothing):

* all-gather, per forward pass (twice in a train step: remat runs the
  forward again in the backward), of each weight sharded over a batch axis
  (``S_W & S_B``): result ``bytes(W) / k(S_W - S_B)``;
* reduce-scatter of each such weight's gradient (train): result
  ``bytes(W) / k(S_W)``; an all-reduce of the gradient over the batch axes
  the weight is not sharded on (``S_B - S_W``): result ``bytes(W) /
  k(S_W)``;
* all-reduce of the activation after each matmul whose contraction dim
  lies on a non-batch (tensor) axis, per forward pass, and in a train step
  once more for the gradient of the split region's input (Megatron's
  ``f``, counted at the same size): result ``tokens / k(S_B) * N_out *
  itemsize``, ``N_out`` the matmul's output width (for a MoE expert
  weight, its tokens are the assignments, tokens times top-k).  Where the
  rules put ``seq_act`` on those axes (sequence parallelism; not in a
  decode step) each such all-reduce is one reduce-scatter, result that
  size over ``k`` of the axes, and one all-gather of that size;
* a tied token table read as a vocab-split head (``tied_vocab``; the
  model splits a head of ``VOCAB_SPLIT_MIN`` entries or more on a tensor
  axis): in a train step, an all-reduce of the table's gradient over that
  axis (each rank's head rows beside every rank's lookup), result
  ``bytes(W)``.

A weight is a matmul operand when it has two dims or more, except the
token table (a gather; a tied head is a matmul over it, contracting on
``embed``), the depthwise conv taps and the sLSTM's block-diagonal
recurrence.  The optimizer reckons no collective (its norm's all-reduce of
a scalar is left out).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.distributed.api import mesh_axes
from repro_torch.serving.profiles import H100

__all__ = [
    "HW",
    "Component",
    "cost_terms",
    "CellReport",
    "combine_components",
    "reckon_collectives",
]

HW = dict(H100)

_NOT_MATMUL = ("tokens", "conv_w", "ri", "rf", "rz", "ro")


@dataclasses.dataclass
class Component:
    """One traced cost component with its multiplier."""

    name: str
    flops: float
    bytes_accessed: float
    coll_bytes: Dict[str, int]
    multiplier: float = 1.0


def combine_components(components) -> Dict[str, float]:
    flops = sum(c.flops * c.multiplier for c in components)
    byts = sum(c.bytes_accessed * c.multiplier for c in components)
    coll = 0.0
    coll_by_kind: Dict[str, float] = {}
    for c in components:
        for k, v in c.coll_bytes.items():
            coll_by_kind[k] = coll_by_kind.get(k, 0.0) + v * c.multiplier
            coll += v * c.multiplier
    return {"flops": flops, "bytes": byts, "coll_bytes": coll, "coll_by_kind": coll_by_kind}


def cost_terms(totals: Dict[str, float], chips: int) -> Dict[str, float]:
    """The three roofline terms in seconds; ``totals`` are per device."""
    return {
        "compute_s": totals["flops"] / HW["peak_flops"],
        "memory_s": totals["bytes"] / HW["hbm_bw"],
        "collective_s": totals["coll_bytes"] / HW["link_bw"],
    }


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    terms_s: Dict[str, float]
    totals: Dict[str, float]
    model_flops: float
    bytes_per_device: Optional[int]
    coll_census: Dict[str, int]  # collective kind -> count
    status: str = "ok"
    note: str = ""

    @property
    def dominant(self) -> str:
        return max(self.terms_s, key=lambda k: self.terms_s[k])

    @property
    def useful_ratio(self) -> float:
        hlo = self.totals["flops"] * self.chips
        return self.model_flops / hlo if hlo else 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["model_flops_over_hlo"] = self.useful_ratio
        return d


def _axes_of(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def reckon_collectives(weights, rules, mesh, *, tokens: int, itemsize: int, train: bool,
                       top_k: int = 1, decode: bool = False, tied_vocab: bool = False):
    """``(bytes by kind, count by kind)`` of one call of a component whose
    weights are ``weights``: ``[(path, shape, logical axes, bytes per
    element)]``; ``tokens``: the global tokens of the call; ``itemsize``:
    the activations' bytes per element; ``decode``: a decode step, which
    keeps whole rows under sequence parallelism; ``tied_vocab``: the token
    table is the vocab-split head too (see the module docstring)."""
    names, sizes = mesh_axes(mesh)
    size = dict(zip(names, sizes))

    def k(axes):
        n = 1
        for ax in axes:
            n *= size[ax]
        return n

    def split(entry):  # the mesh axes of an entry that have more than one rank
        return {ax for ax in _axes_of(entry) if size[ax] > 1}

    batch = split(rules.table.get("batch"))
    seq = set() if decode else split(rules.table.get("seq_act"))
    tok_local = -(-tokens // k(batch))
    passes = 2 if train else 1
    out: Dict[str, int] = {}
    count: Dict[str, int] = {}

    def add(kind, nbytes, n=1):
        out[kind] = out.get(kind, 0) + int(nbytes) * n
        count[kind] = count.get(kind, 0) + n

    for path, shape, axes, elem in weights:
        dims = [split(e) for e in rules.spec(axes)]
        sharded = set().union(*dims) if dims else set()
        nbytes = elem
        for s in shape:
            nbytes *= s
        if sharded & batch:
            add("all-gather", -(-nbytes // k(sharded - batch)), passes)
            if train:
                add("reduce-scatter", -(-nbytes // k(sharded)))
        if train and batch - sharded:
            add("all-reduce", -(-nbytes // k(sharded)))
        name = path[-1]
        if train and tied_vocab and name == "tokens" and split(rules.table.get("vocab")) - batch:
            add("all-reduce", nbytes)
        if len(shape) >= 2 and name not in _NOT_MATMUL:
            tensor = dims[-2] - batch
            if tensor:
                toks = tok_local * (top_k if len(shape) == 3 else 1)
                act = toks * shape[-1] * itemsize
                n = passes + (1 if train else 0)
                if tensor <= seq:
                    add("reduce-scatter", -(-act // k(tensor)), n)
                    add("all-gather", act, n)
                else:
                    add("all-reduce", act, n)
    return out, count
