"""The port's sharding rules and activation constraints
(``repro_torch.sharding``) against the JAX package's.

Parameter and cache trees come at full size without memory: JAX's from
``jax.eval_shape``, the port's under ``FakeTensorMode``.  Each spec is
compared entry for entry (``tuple(jax_spec) == tuple(port_spec)``).  The
constraint a ``constrain_*`` picks is recorded by replacing each
package's ``_wsc`` inside the test (``monkeypatch``); neither package is
changed.  ``placements`` is checked on a fake 8-rank world: the block a
rank keeps of a dim split over ("pod", "data") is JAX's row-major one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.sharding import context as jctx
from repro.sharding.rules import ShardingRules as JaxRules
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.models import lm
from repro_torch.sharding import context as shctx
from repro_torch.sharding.rules import P, ShardingRules, placements
from repro_torch.tree import tree_items

MESHES = [dict(model_size=16, data_size=16), dict(model_size=2, data_size=2)]


def _jax_items(tree, prefix=""):
    """(path, leaf) of a JAX tree of dicts in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _jax_items(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def _specs_equal(jax_specs, port_specs):
    j = _jax_items(jax_specs)
    p = tree_items(port_specs)
    assert [k for k, _ in j] == [k for k, _ in p]
    bad = [(k, tuple(a), tuple(b)) for (k, a), (_, b) in zip(j, p)
           if tuple(a) != tuple(b)]
    assert not bad, bad[:5]
    return len(j)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("mesh", MESHES, ids=["16x16", "2x2"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, mesh, multi_pod):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jparams = jax.eval_shape(lambda k: jlm.init_params(jcfg, k),
                             jax.random.PRNGKey(0))
    with FakeTensorMode():
        params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    jr = JaxRules(jcfg, multi_pod=multi_pod, **mesh)
    r = ShardingRules(cfg, multi_pod=multi_pod, **mesh)
    assert _specs_equal(jr.param_specs(jparams), r.param_specs(params)) > 5
    for flag in ("heads_shardable", "kv_shardable", "ff_shardable",
                 "dmodel_shardable", "dinner_shardable"):
        assert getattr(r, flag) == getattr(jr, flag), flag


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("mesh", MESHES, ids=["16x16", "2x2"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_io_specs_equal_jax(arch, mesh, multi_pod):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jr = JaxRules(jcfg, multi_pod=multi_pod, **mesh)
    r = ShardingRules(cfg, multi_pod=multi_pod, **mesh)
    for name in ("decode_32k", "long_500k"):
        B, S = SHAPES[name].global_batch, SHAPES[name].seq_len
        jc = jax.eval_shape(lambda _: jlm.init_caches(jcfg, B, S), 0)
        with FakeTensorMode():
            caches = lm.init_caches(cfg, B, S, device="cpu")
        _specs_equal(jr.cache_specs(jc, B), r.cache_specs(caches, B))
    for batch in (0, 1, 32, 128, 256):
        for fn in ("tokens_spec", "logits_spec", "encoder_spec"):
            assert tuple(getattr(jr, fn)(batch)) \
                == tuple(getattr(r, fn)(batch)), (fn, batch)
        assert jr._bshard(batch) == r._bshard(batch)


# (arch, rules kwargs, shapes fed to each constraint): phi3's 40 heads,
# granite-moe's 24 and xLSTM's 4 do not divide 16; qwen3's 32 do
CONSTRAINT_ARCHS = ["phi3_medium_14b", "granite_moe_3b_a800m", "xlstm_1_3b",
                    "qwen3_8b"]


def _record(monkeypatch, module):
    seen = []

    def wsc(x, spec):
        seen.append(tuple(spec))
        return x
    monkeypatch.setattr(module, "_wsc", wsc)
    return seen


def _constraint_calls(ctx, zeros, cfg):
    """Every constraint on head, ff, residual, expert and state shapes of
    ``cfg`` (train and decode sequence lengths, batches that the data
    axis divides and that it does not)."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    for b in (32, 1):
        for s in (4096, 1, 24):
            ctx.constrain_heads(zeros((b, s, h, hd)), role="q")
            ctx.constrain_heads(zeros((b, s, hkv, hd)), role="kv")
            ctx.constrain_heads(zeros((b, s, h, hd)), role="kv")
            ctx.constrain_ff(zeros((b, s, cfg.d_ff or 48)))
            ctx.constrain_resid(zeros((b, s, 64)))
        ctx.constrain_expert(zeros((b, 8, 10, 64)))
        ctx.constrain_state_matrix(zeros((b, 4, h, hd, hd)))
        ctx.constrain_state_matrix(zeros((b, 2, 4, h, 24, hd)))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", CONSTRAINT_ARCHS)
def test_constraints_pick_jax_specs(arch, multi_pod, monkeypatch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jseen = _record(monkeypatch, jctx)
    pseen = _record(monkeypatch, shctx)
    # small stand-ins: the constraints read shapes only
    jzeros = lambda shape: jax.ShapeDtypeStruct(shape, jnp.float32)
    with FakeTensorMode():
        tzeros = lambda shape: torch.zeros(shape)
        with jctx.use_rules(JaxRules(jcfg, multi_pod=multi_pod)):
            _constraint_calls(jctx, jzeros, jcfg)
        with shctx.use_rules(ShardingRules(cfg, multi_pod=multi_pod)):
            _constraint_calls(shctx, tzeros, cfg)
    assert len(jseen) == len(pseen) == 36
    assert jseen == pseen
    assert len(set(pseen)) > 5


def test_constraints_are_identity_without_rules():
    x = torch.ones((2, 8, 4, 16))
    assert shctx.get() is None
    assert shctx.constrain_heads(x) is x
    assert shctx.constrain_ff(x[..., 0, :]) is not None
    for fn, t in ((shctx.constrain_ff, torch.ones(2, 8, 64)),
                  (shctx.constrain_resid, torch.ones(2, 8, 64)),
                  (shctx.constrain_expert, torch.ones(2, 4, 3, 64)),
                  (shctx.constrain_state_matrix, torch.ones(2, 3, 4, 8, 8))):
        assert fn(t) is t
    assert shctx.constrain(x, P(None, None, "model", None)) is x
    assert shctx.unshard(x, -1) is x


def test_constraints_leave_plain_tensors_under_rules():
    """Rules active, tensors not DTensors: nothing is redistributed (the
    single-device path of every layer)."""
    x = torch.ones((32, 8, 16, 4))
    with shctx.use_rules(ShardingRules(get_config("qwen3_8b"))):
        assert shctx.get() is not None
        assert shctx.constrain_heads(x) is x
        assert shctx.constrain_resid(x[..., 0]) is not None
    assert shctx.get() is None


@pytest.fixture
def fake_world_8():
    from repro_torch.launch.mesh import fake_world
    with fake_world(8):
        yield


@pytest.mark.parametrize("spec", [P(("pod", "data"), None),
                                  P(("pod", "data"), "model"),
                                  P(None, ("pod", "data")),
                                  P("model", "data")])
def test_placements_give_jax_row_major_blocks(spec):
    """On a (2, 2, 2) mesh, the block DTensor gives each rank under
    ``placements(spec)`` is the block of JAX's named sharding: a dim over
    ("pod", "data") is cut into pod x data blocks, rank (p, d, m) keeping
    block p * 2 + d.  Each rank is traced in its own fake world."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from repro_torch.launch.mesh import fake_world
    axes = ("pod", "data", "model")
    shape = (8, 16)
    for rank in range(8):
        coord = np.unravel_index(rank, (2, 2, 2))
        with fake_world(8, rank=rank):
            mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=axes)
            local, offset = compute_local_shape_and_global_offset(
                shape, mesh, placements(spec, mesh))
        for d, e in enumerate(spec):
            names = [a for a in (e if isinstance(e, tuple) else (e,)) if a]
            block, n = 0, 1
            for a in names:
                block = block * 2 + int(coord[axes.index(a)])
                n *= 2
            assert local[d] == shape[d] // n
            assert offset[d] == block * local[d], (rank, spec, offset)


def test_placements_keep_indivisible_dims_whole(fake_world_8):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    spec = P("data", None, "model")
    assert placements(spec, mesh) == (Shard(0), Shard(2))
    assert placements(spec, mesh, (1, 3, 8)) == (Replicate(), Shard(2))
    assert placements(spec, mesh, (4, 3, 6)) == (Shard(0), Replicate())
