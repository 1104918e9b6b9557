"""Mesh construction, the JAX package's ``launch/mesh.py`` in PyTorch.

:func:`make_mesh` builds a ``torch.distributed`` ``DeviceMesh`` over the
ranks of the initialized process group (CUDA with NCCL by default; the CPU
with gloo when asked for).  The production meshes of the dry-run, (16, 16)
and (2, 16, 16), have more ranks than one process can hold, so
:func:`make_production_mesh` returns their :class:`MeshShape` (axis names
and sizes), which is all the dry-run reads.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed.api import (
    RULES_2D, RULES_2D_DEC, RULES_2D_SP, RULES_3D, RULES_3D_DEC, RULES_3D_SP,
    AxisRules, mesh_axes,
)

__all__ = ["MeshShape", "make_mesh", "make_production_mesh", "make_rules",
           "make_custom_mesh", "make_elastic_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without ranks (``DeviceMesh``'s
    ``shape`` and ``mesh_dim_names``)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def make_mesh(shape, axes, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process group's
    ranks (their count must be the product of ``shape``); ``device`` is
    ``cuda`` or ``cpu``.  The process group must be initialized."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group; torchrun sets WORLD_SIZE)")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_rules(mesh, *, seq_parallel: bool = False, decode_opt: bool = False) -> AxisRules:
    names, _ = mesh_axes(mesh)
    if "pod" in names:
        table = RULES_3D_SP if seq_parallel else (RULES_3D_DEC if decode_opt else RULES_3D)
    else:
        table = RULES_2D_SP if seq_parallel else (RULES_2D_DEC if decode_opt else RULES_2D)
    return AxisRules(mesh, table)


def make_custom_mesh(data: int, model: int) -> MeshShape:
    """An arbitrary (data, model) factorization of one pod, by shape."""
    return MeshShape((data, model), ("data", "model"))


def elastic_shape(n: int, model_parallel: int = 16) -> Tuple[int, int]:
    """(data, model) for ``n`` ranks: the tensor axis kept at
    ``model_parallel`` (or the largest divisor of ``n`` below it), every
    other rank given to data parallelism."""
    mp = min(model_parallel, n)
    while n % mp:
        mp -= 1
    return n // mp, mp


def make_elastic_mesh(model_parallel: int = 16, device: str = "cuda"):
    """The best (data, model) mesh for the ranks alive now (elastic restart):
    the tensor axis fixed, every other rank data-parallel; restoring a
    checkpoint onto it is a pure re-shard (``CheckpointManager.restore``
    with ``shardings``)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(elastic_shape(n, model_parallel), ("data", "model"), device)
