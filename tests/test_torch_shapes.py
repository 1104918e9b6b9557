"""The dry-run's shape cells in the port against the JAX package's
``configs/shapes.py``: the cells, the skip rules, and the inputs (meta
tensors against ``jax.ShapeDtypeStruct``), the decode cache tree against
``jax.eval_shape(init_cache)``.  Shapes only: nothing is allocated."""
import dataclasses

import jax
import pytest

from repro.configs import shapes as jshapes
from repro.configs.archs import ARCH_IDS
from repro.configs.archs import get_config as jget
from repro_torch.configs import shapes
from repro_torch.configs.archs import get_config
from repro_torch.tree import named_leaves

CELLS = [(a, s) for a in ARCH_IDS for s in jshapes.SHAPES]
APPLICABLE = [(a, s) for a, s in CELLS if jshapes.applicable(jget(a), s)]


def _dtype(dt) -> str:
    return str(dt).split(".")[-1]


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = (tuple(leaf.shape), _dtype(leaf.dtype))
    return out


def _torch_leaves(tree):
    return {k: (tuple(t.shape), _dtype(t.dtype)) for k, t in named_leaves(tree)}


def test_shape_cells_equal_jax():
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, cell in shapes.SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(jshapes.SHAPES[name])


def test_package_exports_shapes():
    from repro_torch import configs

    for name in ("SHAPES", "applicable", "input_specs", "skip_reason"):
        assert getattr(configs, name) is getattr(shapes, name)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_skip_rules_equal_jax(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    assert shapes.skip_reason(cfg, shape) == jshapes.skip_reason(jcfg, shape)
    assert shapes.applicable(cfg, shape) == jshapes.applicable(jcfg, shape)


@pytest.mark.parametrize("arch,shape", APPLICABLE)
def test_input_specs_equal_jax(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    got = shapes.input_specs(cfg, shape)
    want = jshapes.input_specs(jcfg, shape)
    assert got.keys() == want.keys()
    for leaf in (t for _, t in named_leaves(got)):
        assert leaf.device.type == "meta"
    assert _torch_leaves(got) == _jax_leaves(want)


def test_batch_override():
    cfg = get_config("gemma-2b")
    got = shapes.input_specs(cfg, "decode_32k", batch_override=3)
    want = jshapes.input_specs(jget("gemma-2b"), "decode_32k", batch_override=3)
    assert _torch_leaves(got) == _jax_leaves(want)
