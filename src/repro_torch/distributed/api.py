"""Logical-axis sharding API (MaxText-style rules), the JAX package's
``distributed/api.py`` in PyTorch.

Model code never names mesh axes.  Arrays carry *logical* axes ("batch",
"embed", "heads", ...): the parameter and cache axes tables of
:mod:`repro_torch.models.transformer`, and :func:`constrain` on an
activation.  A rule set maps logical axes to mesh axes; outside an active
rule set every annotation is a no-op, so single-device code runs with no
ceremony.

A rule set turns logical axes into a :class:`PartitionSpec` (one entry
per tensor dim: None, a mesh axis, or a tuple of mesh axes that shard that
dim together, major to minor) and that into DTensor placements, one
``Shard(dim)`` or ``Replicate()`` per mesh dim.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` or, where only its shape
matters (the dry-run's 256- and 512-chip meshes, which one process cannot
build), a :class:`~repro_torch.launch.mesh.MeshShape`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Tuple

from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = [
    "AxisRules",
    "PartitionSpec",
    "Sharding",
    "axis_rules",
    "active_rules",
    "constrain",
    "logical_to_spec",
    "named_sharding",
    "mesh_axes",
    "RULES_1D",
    "RULES_2D",
    "RULES_2D_SP",
    "RULES_2D_DEC",
    "RULES_3D",
    "RULES_3D_SP",
    "RULES_3D_DEC",
]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of mesh axis names (major to minor).  Normalized as
    ``jax.sharding.PartitionSpec`` is (a one-axis tuple is that axis, an
    empty one None), and equal to a tuple of the same entries."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple) and len(e) <= 1:
                return e[0] if e else None
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """``(axis names, sizes)`` of a DeviceMesh or a MeshShape."""
    return tuple(mesh.mesh_dim_names), tuple(mesh.shape)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives: ``mesh``, its ``spec`` and the DTensor
    ``placements`` on the mesh (the port's ``NamedSharding``)."""

    mesh: object
    spec: PartitionSpec
    placements: tuple

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The largest per-device shard of ``shape``: each dim divided by
        the product of its mesh axes' sizes, rounded up (an uneven split
        leaves the last devices a smaller or empty shard)."""
        names, sizes = mesh_axes(self.mesh)
        size = dict(zip(names, sizes))
        out = []
        for i, n in enumerate(shape):
            k = 1
            for ax in _entry_axes(self.spec[i] if i < len(self.spec) else None):
                k *= size[ax]
            out.append(-(-n // k))
        return tuple(out)


class AxisRules:
    """Mapping from logical axis names to mesh axes (or None = replicate)."""

    def __init__(self, mesh, table: dict):
        self.mesh = mesh
        self.table = dict(table)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        out = []
        for ax in logical_axes:
            if ax is None:
                out.append(None)
            else:
                if ax not in self.table:
                    raise KeyError(f"no rule for logical axis {ax!r}")
                out.append(self.table[ax])
        return PartitionSpec(*out)

    @staticmethod
    def placements(spec: PartitionSpec, mesh) -> tuple:
        """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
        mesh dim that shards a tensor dim, ``Replicate()`` elsewhere.  A dim
        sharded over several mesh axes must name them in the mesh's order
        (major to minor, the order DTensor splits in); a mesh axis may shard
        one tensor dim only."""
        names, _ = mesh_axes(mesh)
        placements = [Replicate()] * len(names)
        for dim, entry in enumerate(spec):
            axes = _entry_axes(entry)
            idx = []
            for ax in axes:
                if ax not in names:
                    raise ValueError(f"spec {spec!r} names mesh axis {ax!r}; mesh has {names}")
                idx.append(names.index(ax))
            if idx != sorted(idx):
                raise ValueError(f"spec {spec!r}: dim {dim} axes {axes} not in the mesh's "
                                 f"order {names}")
            for i in idx:
                if isinstance(placements[i], Shard):
                    raise ValueError(f"spec {spec!r} shards two dims over {names[i]!r}")
                placements[i] = Shard(dim)
        return tuple(placements)


_state = threading.local()


def active_rules() -> Optional[AxisRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: Optional[AxisRules]):
    prev = active_rules()
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def constrain(x, *logical_axes):
    """Place ``x`` by the active rules: a no-op without rules (or without a
    mesh in them); a DTensor is redistributed to the logical axes'
    placements on the rules' mesh; any other tensor raises ``TypeError``,
    since a plain tensor holds no placement to change."""
    rules = active_rules()
    if rules is None or rules.mesh is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain under a mesh needs a DTensor, got {type(x).__name__}")
    spec = rules.spec(logical_axes)
    return x.redistribute(rules.mesh, AxisRules.placements(spec, rules.mesh))


def logical_to_spec(logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
    rules = active_rules()
    if rules is None:
        return PartitionSpec()
    return rules.spec(logical_axes)


def named_sharding(mesh, rules: AxisRules, logical_axes) -> Sharding:
    spec = rules.spec(logical_axes)
    return Sharding(mesh, spec, AxisRules.placements(spec, mesh))


# ---------------------------------------------------------------------------
# Standard rule tables (the JAX package's, as data).
#
# Logical axes:
#   batch       global batch                   -> all data-parallel axes
#   seq         sequence (activations)         -> unsharded by default
#   embed       d_model                        -> FSDP axis on weights
#   heads       attention query heads          -> tensor axis
#   kv_heads    attention kv heads             -> tensor axis
#   ffn         MLP hidden                     -> tensor axis
#   vocab       vocabulary                     -> tensor axis
#   experts     MoE experts                    -> unsharded (expert weights are
#                                                 TP on expert_ffn + FSDP on embed)
#   expert_ffn  per-expert hidden              -> tensor axis
#   moe_groups  MoE token groups               -> the data axes
#   lru         recurrent (RG-LRU/xLSTM) width -> tensor axis
#   seq_kv      decode KV-cache slots          -> tensor axis
#   seq_act     residual-stream seq dim        -> "model" under sequence parallelism
#   embed_act   decode residual d_model dim    -> unsharded
#   stats       tiny per-request arrays        -> replicated
# ---------------------------------------------------------------------------
def _table(data_axes, tensor_axis):
    return {
        "batch": data_axes,
        "seq": None,
        "embed": data_axes if isinstance(data_axes, str) else "data",
        "heads": tensor_axis,
        "kv_heads": tensor_axis,
        "ffn": tensor_axis,
        "vocab": tensor_axis,
        "experts": None,
        "expert_ffn": tensor_axis,
        "moe_groups": data_axes,
        "lru": tensor_axis,
        "seq_kv": tensor_axis,
        "seq_act": None,
        "embed_act": None,
        "stats": None,
    }


RULES_1D = {  # single device
    "batch": None,
    "seq_kv": None,
    "seq_act": None,
    "embed_act": None,
    "seq": None,
    "embed": None,
    "heads": None,
    "kv_heads": None,
    "ffn": None,
    "vocab": None,
    "experts": None,
    "expert_ffn": None,
    "moe_groups": None,
    "lru": None,
    "stats": None,
}

# Single pod: 16x16 ("data", "model").
RULES_2D = _table("data", "model")
RULES_2D["batch"] = ("data",)

# Two pods: (2, 16, 16) ("pod", "data", "model").  Weights sharded over
# "data" (intra-pod) and replicated across "pod"; batch over ("pod", "data").
RULES_3D = _table("data", "model")
RULES_3D["batch"] = ("pod", "data")
RULES_3D["moe_groups"] = ("pod", "data")

# Sequence-parallel variants: the residual stream sharded over the tensor
# axis between blocks.
RULES_2D_SP = dict(RULES_2D, seq_act="model")
RULES_3D_SP = dict(RULES_3D, seq_act="model")

# Serving-replica decode: the data axis holds independent tensor-parallel
# replicas, weights not sharded over it (no per-step weight gathers).
RULES_2D_DEC = dict(RULES_2D, embed=None, moe_groups=None)
RULES_3D_DEC = dict(RULES_3D, embed=None, moe_groups=None)
