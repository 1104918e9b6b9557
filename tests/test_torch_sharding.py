"""Distribution plumbing of the port against the JAX package's (mirrors
``tests/test_sharding.py`` and ``tests/test_checkpoint.py``'s reshard):
axis rules and specs, the model's parameter and cache axes, the mesh
constructors, restore with shardings, and one two-rank run (gloo over a
``FileStore``) of the sharded train step, the reshard and
``compressed_psum`` against one process and the JAX package."""
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs.archs import ARCH_IDS
from repro.configs.archs import get_config as jget
from repro.distributed import api as japi
from repro.distributed import compression as jcomp
from repro.launch import mesh as jmesh
from repro.models import transformer as J
from repro.training import train_loop as jtrain
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.archs import get_config, reduced
from repro_torch.distributed import api
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.launch import mesh
from repro_torch.models import transformer as T
from repro_torch.training import (
    TrainConfig, batch_shardings, init_train_state, make_train_step, place_state, state_axes,
    state_shardings,
)
from repro_torch.tree import named_leaves

HERE = Path(__file__).resolve().parent
TABLES = ("RULES_1D", "RULES_2D", "RULES_2D_SP", "RULES_2D_DEC", "RULES_3D", "RULES_3D_SP",
          "RULES_3D_DEC")
# f32 sums of the two ranks' shares against one backward: step 0's new
# parameters agree within this (measured 3.3e-6 plain, 4.8e-7 compressed,
# 1.2e-7 compressed over two microbatches).
SHARDED_ATOL = 2e-5


def _is_axes(x):
    return isinstance(x, tuple) and len(x) > 0 and all(isinstance(e, (str, type(None)))
                                                     for e in x)


def _axes_leaves(tree, path=""):
    """{path: axes} of an axes tree, with ``named_leaves``' paths (a 0-d
    leaf's axes are ``()``)."""
    if _is_axes(tree) or (tree == () and path.endswith("step")):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_axes_leaves(v, f"{path}/{k}" if path else str(k)))
    return out


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo process group over a FileStore in ``tmp_path``."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("table", TABLES)
def test_rule_tables_equal_jax(table):
    assert getattr(api, table) == getattr(japi, table)


@pytest.mark.parametrize("table", TABLES)
def test_every_logical_axis_gives_jax_spec(table):
    r, jr = api.AxisRules(None, getattr(api, table)), japi.AxisRules(None, getattr(japi, table))
    for ax in list(getattr(api, table)) + [None]:
        assert tuple(r.spec((ax,))) == tuple(jr.spec((ax,))), ax
    axes = ("batch", None, "heads", "embed")
    assert r.spec(axes) == tuple(jr.spec(axes))


def test_rules_translate_specs():
    r = api.AxisRules(None, api.RULES_2D)
    assert r.spec(("batch", None, "heads")) == ("data", None, "model")
    assert repr(r.spec((None,))) == "P(None,)"
    r3 = api.AxisRules(None, api.RULES_3D)
    assert r3.spec(("batch",)) == (("pod", "data"),)
    assert r3.spec(("moe_groups",)) == (("pod", "data"),)


def test_unknown_logical_axis_raises():
    with pytest.raises(KeyError):
        api.AxisRules(None, api.RULES_2D).spec(("nonexistent",))


def test_constrain_is_noop_without_rules():
    x = torch.ones(4, 4)
    assert api.constrain(x, "batch", None) is x
    with api.axis_rules(api.AxisRules(None, api.RULES_2D)):  # no mesh: nothing to place
        assert api.constrain(x, "batch", None) is x
    assert api.logical_to_spec(("batch",)) == ()


def test_constrain_plain_tensor_under_mesh_raises():
    rules = api.AxisRules(mesh.make_production_mesh(), api.RULES_2D)
    with api.axis_rules(rules), pytest.raises(TypeError):
        api.constrain(torch.ones(4, 4), "batch", None)
    with api.axis_rules(rules):
        assert api.logical_to_spec(("batch", "heads")) == ("data", "model")


def test_constrain_redistributes_a_dtensor(world1):
    m = mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    x = DTensor.from_local(torch.arange(12.0).reshape(3, 4), m, [Replicate(), Replicate()])
    with api.axis_rules(api.AxisRules(m, api.RULES_2D)):
        y = api.constrain(x, "batch", "heads")
    assert y.placements == (Shard(0), Shard(1))
    assert torch.equal(y.full_tensor(), x.full_tensor())


def test_placements_and_shard_shapes():
    m3 = mesh.make_production_mesh(multi_pod=True)
    assert (m3.shape, m3.mesh_dim_names) == ((2, 16, 16), ("pod", "data", "model"))
    m2 = mesh.make_production_mesh()
    assert (m2.shape, m2.mesh_dim_names, m2.size()) == ((16, 16), ("data", "model"), 256)
    r3 = mesh.make_rules(m3)
    s = api.named_sharding(m3, r3, ("batch", None, "heads"))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    assert s.shard_shape((65, 33, 40)) == (3, 33, 3)  # ceil(65 / 32), ceil(40 / 16)
    s = api.named_sharding(m3, r3, ("embed", "heads"))
    assert s.placements == (Replicate(), Shard(0), Shard(1))
    assert s.shard_shape((33, 17)) == (3, 2)
    with pytest.raises(ValueError, match="two dims"):
        api.named_sharding(m3, r3, ("batch", "embed"))  # "data" twice
    assert api.named_sharding(m3, r3, (None, "embed")).placements == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        api.AxisRules.placements((("data", "pod"),), m3)
    with pytest.raises(ValueError, match="two dims"):
        api.AxisRules.placements(("data", "data"), m3)
    with pytest.raises(ValueError, match="mesh axis"):
        api.AxisRules.placements(("pod",), m2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_axes_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert T.param_axes(cfg) == J.param_axes(jcfg)
    if not cfg.encoder_only:
        assert T.cache_axes(cfg) == J.cache_axes(jcfg)
    # The axes tree has the parameters' structure and one axis per dim.
    leaves = dict(named_leaves(T.init_params(cfg, device="meta")))
    axes = _axes_leaves(T.param_axes(cfg))
    assert list(axes) == list(leaves)
    for k, a in axes.items():
        assert len(a) == leaves[k].dim(), k


def test_kv_quant_cache_axes_equal_jax():
    import dataclasses

    cfg = dataclasses.replace(get_config("qwen3-14b"), kv_cache_quant=True)
    jcfg = dataclasses.replace(jget("qwen3-14b"), kv_cache_quant=True)
    assert T.cache_axes(cfg) == J.cache_axes(jcfg)


@pytest.mark.parametrize("compression", [False, True])
def test_state_axes_equal_jax(compression):
    cfg = get_config("recurrentgemma-2b")
    assert state_axes(cfg, TrainConfig(grad_compression=compression)) == jtrain.state_axes(
        jget("recurrentgemma-2b"), jtrain.TrainConfig(grad_compression=compression))


def test_param_axes_cover_rules():
    """Every logical axis used by any arch has a rule in every table."""
    used = set()
    for arch in ARCH_IDS:
        for tree in (T.param_axes(reduced(arch)),
                     {} if reduced(arch).encoder_only else T.cache_axes(reduced(arch))):
            stack = [tree]
            while stack:
                node = stack.pop()
                if _is_axes(node):
                    used.update(a for a in node if a)
                elif isinstance(node, dict):
                    stack.extend(node.values())
                else:
                    stack.extend(node)
    assert used
    for table in TABLES:
        assert not used - set(getattr(api, table)), table


@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data", "model")])
@pytest.mark.parametrize("sp,dec", [(False, False), (True, False), (False, True)])
def test_make_rules_table_choice(axes, sp, dec):
    got = mesh.make_rules(mesh.MeshShape((1,) * len(axes), axes), seq_parallel=sp,
                          decode_opt=dec)
    want = jmesh.make_rules(types.SimpleNamespace(axis_names=axes), seq_parallel=sp,
                            decode_opt=dec)
    assert got.table == want.table


@pytest.mark.parametrize("n", [1, 2, 3, 8, 12, 16, 24, 64, 256, 512])
def test_elastic_shape_equals_jax(n, monkeypatch):
    monkeypatch.setattr(jmesh.jax, "devices", lambda: [None] * n)
    monkeypatch.setattr(jmesh, "make_mesh", lambda shape, axes: tuple(shape))
    assert mesh.elastic_shape(n) == jmesh.make_elastic_mesh()
    assert mesh.make_custom_mesh(n, 1).shape == (n, 1)


def test_elastic_mesh_single_rank(world1):
    m = mesh.make_elastic_mesh(model_parallel=16, device="cpu")
    assert tuple(m.shape) == (1, 1)
    assert tuple(m.mesh_dim_names) == ("data", "model")


def test_batch_and_state_shardings():
    m = mesh.make_production_mesh(multi_pod=True)
    rules = mesh.make_rules(m)
    batch = {"tokens": torch.zeros(64, 8, dtype=torch.int32),
             "patches": torch.zeros(64, 4, 3)}
    sh = batch_shardings(m, rules, batch)
    assert sh["tokens"].spec == (("pod", "data"), None)
    assert sh["patches"].placements == (Shard(0), Shard(0), Replicate())
    cfg = reduced("gemma-2b")
    st = state_shardings(cfg, m, rules, TrainConfig(grad_compression=True))
    assert set(st) == {"params", "opt", "error_fb"}
    assert st["opt"]["step"].placements == (Replicate(),) * 3
    assert st["params"]["embed"]["tokens"].spec == (None, "data")


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh((1, 1), ("data", "model"), device="cpu")


EMULATED_RTOL = 1e-10


@pytest.mark.parametrize("arch,over,size,error,match", [
    ("recurrentgemma-2b", {"lru_width": 66}, 4, ValueError,
     r"rec/\w+ dim \d \(lru, 66\) does not evenly divide over 4"),
    ("xlstm-350m", {"pattern": ("mlstm",)}, 3, ValueError,
     r"cell/wq dim 1 \(lru, 128\) does not evenly divide over 3"),
    ("xlstm-350m", {"pattern": ("slstm",), "xlstm_heads": 2}, 4, None, None),
    ("llama3-8b", {"n_heads": 6, "n_kv_heads": 2}, 4, None, None),
    ("llama3-8b", {"n_heads": 8, "n_kv_heads": 8}, 3, ValueError,
     r"attn/wq dim 1 \(heads, 128\) does not evenly divide over 3"),
    ("llama3-8b", {"n_heads": 6, "n_kv_heads": 2}, 3, ValueError,
     r"attn/wk dim 1 \(kv_heads, 32\) does not evenly divide over 3"),
    ("llama3-8b", {"d_ff": 130}, 4, ValueError,
     r"mlp/wi dim 1 \(ffn, 130\) does not evenly divide over 4"),
    ("olmoe-1b-7b", {"expert_d_ff": 66}, 4, ValueError,
     r"moe/\w+ dim \d \(expert_ffn, 66\) does not evenly divide over 4"),
    ("llama3-8b", {"vocab_size": 1026}, 4, ValueError,
     r"head dim 1 \(vocab, 1026\) does not evenly divide over 4"),
], ids=["recurrent", "mlstm", "slstm", "heads-6-over-4", "heads-8-over-3", "kv-heads-2-over-3",
        "ffn", "expert-ffn", "vocab"])
def test_tensor_axis_raises(world1, arch, over, size, error, match):
    """A ``model`` axis above 1 runs every block kind.  A stored leaf whose
    dim on the tensor axis does not divide over it (an RG-LRU or mLSTM
    width, attention columns, kv columns, an MLP or expert width, a split
    vocab), which the JAX package's placement refuses too, raises before
    the step is built, naming the leaf and the dim.  Heads that do not
    split over the ranks (6 q heads over 4 ranks; 2 sLSTM heads over 4,
    two ranks holding none), which GSPMD pads, build the step, and the
    block split over the ranks (emulated in one process,
    ``torch_tp_worker.emulated_split``) is the unsharded block in float64:
    its output and every gradient within ``EMULATED_RTOL`` of their largest
    entry (the same float64 sums in another order) [5.7e-16 the attention
    block at 6 over 4, 4.3e-16 the sLSTM cell at 2 over 4]."""
    import torch_tp_worker

    m = mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    wide = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, size), ndim=2,
                                 get_coordinate=lambda: (0, 0))
    cfg = reduced(arch, **over)
    if error is not None:
        with pytest.raises(error, match=match):
            make_train_step(cfg, None, TrainConfig(), mesh=wide, rules=mesh.make_rules(m))
        return
    assert callable(make_train_step(cfg, None, TrainConfig(), mesh=wide,
                                    rules=mesh.make_rules(m)))
    kind = cfg.pattern[0]
    err = torch_tp_worker.emulated_block_error(cfg, kind, size)
    assert err <= EMULATED_RTOL, f"{kind} over {size}: {err:.3g}"


@pytest.mark.parametrize("max_len,ok", [(32, True), (30, False), (6, False)])
def test_cache_axes_raise_where_slots_do_not_split(max_len, ok):
    """Serving: a ring whose slots (``seq_kv``) do not divide over the
    tensor axis raises, naming the cache leaf and the dim; the heads (6 q
    over 2 kv on 4 ranks) do not."""
    cfg = reduced("llama3-8b", n_heads=6, n_kv_heads=2)
    if ok:
        tpm.check_config(cfg, 4, cache=(2, max_len))
        return
    with pytest.raises(ValueError, match=rf"cache/periods/0/k dim 2 \(seq_kv, {max_len}\) "
                                         "does not evenly divide over 4"):
        tpm.check_config(cfg, 4, cache=(2, max_len))


def test_reshard_on_restore(tmp_path, world1):
    """Restore with explicit shardings (elastic restart path) on one rank:
    each leaf a DTensor on its sharding, bitwise the saved one, with the
    template's dtype and ``requires_grad``."""
    cfg = reduced("gemma-2b", dtype="bfloat16")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(3, state)
    m = mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    shardings = state_shardings(cfg, m, mesh.make_rules(m))
    restored, step = mgr.restore(state, shardings=shardings)
    assert step == 3
    for (k, a), (_, b), (_, s) in zip(named_leaves(state), named_leaves(restored),
                                      named_leaves(shardings)):
        assert isinstance(b, DTensor) and b.placements == s.placements, k
        assert b.dtype == a.dtype and b.requires_grad == a.requires_grad, k
        assert torch.equal(b.full_tensor(), a), k


def test_sharded_world1_is_the_unsharded_step(world1):
    """On a (1, 1) mesh the sharded step is the unsharded one, bitwise."""
    import torch_dist_worker as worker

    cfg, opt_cfg, batch = worker.model(), worker.OPT, worker.batch()
    m = mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    rules = mesh.make_rules(m)
    for tc in (TrainConfig(microbatches=2), TrainConfig(grad_compression=True)):
        plain = init_train_state(cfg, torch.Generator().manual_seed(0), tc, device="cpu")
        sharded = place_state(init_train_state(cfg, torch.Generator().manual_seed(0), tc,
                                               device="cpu"), state_shardings(cfg, m, rules, tc))
        for _ in range(2):
            plain, pm = make_train_step(cfg, opt_cfg, tc)(plain, batch)
            sharded, sm = make_train_step(cfg, opt_cfg, tc, mesh=m, rules=rules)(sharded, batch)
            for k in pm:
                assert torch.equal(pm[k], sm[k]), k
        for (k, a), (_, b) in zip(named_leaves(plain), named_leaves(sharded)):
            assert torch.equal(a, b.full_tensor()), k


def _spawn(world, out):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_dist_worker.py"), str(r),
                               str(world), str(out / "store"), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]


def test_two_ranks(tmp_path):
    """Two gloo ranks on a (2, 1) mesh: the sharded step (the clip binding,
    plain, with grad_compression, and with both over two microbatches)
    against one process's unsharded step;
    each rank's restored shard against its slice of the saved arrays;
    ``compressed_psum`` bitwise the JAX package's under ``jax.vmap``."""
    import torch_dist_worker as worker

    cfg, opt_cfg, batch = worker.model(), worker.OPT, worker.batch()
    saved = init_train_state(cfg, torch.Generator().manual_seed(5), device="cpu")
    CheckpointManager(tmp_path / "ckpt").save(1, saved)
    rng = np.random.default_rng(9)
    xs = (rng.standard_normal((2, 96, 33)) * np.array([[[1.0]], [[3.0]]])).astype(np.float32)
    np.save(tmp_path / "psum_in.npy", xs)
    _spawn(2, tmp_path)

    for name, tc in worker.TRAIN_CFGS.items():
        state = init_train_state(cfg, torch.Generator().manual_seed(0), tc, device="cpu")
        state, metrics = make_train_step(cfg, opt_cfg, tc)(state, batch)
        assert float(metrics["grad_norm"]) > 4 * opt_cfg.clip_norm  # the clip binds
        got = np.load(tmp_path / f"step_{name}.npz")
        for k, v in named_leaves(state["params"]):
            np.testing.assert_allclose(got[k], v.detach().numpy(), rtol=0, atol=SHARDED_ATOL,
                                       err_msg=f"{name} {k}")
        for k in ("loss", "xent", "tokens"):
            np.testing.assert_allclose(got[f"metric_{k}"], metrics[k].numpy(), rtol=1e-6,
                                       err_msg=f"{name} {k}")

    shards = [np.load(tmp_path / f"restore_{r}.npz") for r in range(2)]
    shape = mesh.MeshShape((2, 1), ("data", "model"))
    rules, axes = mesh.make_rules(shape), _axes_leaves(state_axes(cfg))
    for k, full in named_leaves(saved):
        full = full.detach()
        sharding = api.named_sharding(shape, rules, axes[k])
        placement = sharding.placements[0]
        for r in range(2):
            want = (full.chunk(2, dim=placement.dim)[r] if isinstance(placement, Shard)
                    else full).numpy()
            np.testing.assert_array_equal(shards[r][k], want, err_msg=f"{k} rank {r}")
            assert str(shards[r][f"placements/{k}"]) == str(sharding.placements), k

    jsum = jax.vmap(lambda x: jcomp.compressed_psum(x, "d"), axis_name="d")(jnp.asarray(xs))
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"psum_{r}.npy"), np.asarray(jsum[r]))
