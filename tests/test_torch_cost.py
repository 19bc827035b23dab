"""The port's per-device cost counter (``repro_torch.launch.cost``)
against closed forms and against the JAX package's HLO walker.

The closed-form cases are ``tests/test_hlo_walk.py``'s: one 1024x512x256
product, and n = 1, 4, 8 products of 512^3 (a Python loop, the port's
form of a scan).  The reduced Qwen3 forward and decode step and the
InternLM2 remat train step are counted by both packages on the same
weights and tokens: ``hlo_walk.walk`` over XLA's compiled HLO and
``cost.Counter`` over the port's aten ops.  Both count 2·M·N·K per
product (dots and convolutions only); the counts are equal on these
programs (held to 1e-6 relative: the remat recompute is counted by both,
and no product with a unit dimension is rewritten by XLA in them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import hlo_analysis
from repro.launch.hlo_walk import walk
from repro.models import lm as jlm
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.convert import tree_from_jax
from repro_torch.launch import cost
from repro_torch.models import lm
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import make_train_step


def test_plain_matmul_exact():
    a, b = torch.randn(1024, 512), torch.randn(512, 256)
    with cost.Counter() as c:
        a @ b
    assert c.flops == 2 * 1024 * 512 * 256
    assert c.coll_bytes == 0
    # one product: both operands read, the result written
    assert c.hbm_bytes == 4 * (1024 * 512 + 512 * 256 + 1024 * 256)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_loop_of_products_counts_every_trip(n):
    x, ws = torch.randn(512, 512), torch.randn(n, 512, 512)
    with cost.Counter() as c:
        for w in ws:
            x = x @ w
    assert c.flops == 2 * n * 512 ** 3


def test_peak_bytes_follow_live_storages():
    a = torch.randn(256, 256)
    with cost.Counter() as c:
        c.track(a)
        b = a * 2
        d = b + 1
        del b
        e = d * 3
    assert c.peak == 3 * a.nbytes         # a, b, d alive at once
    assert c.live == 3 * a.nbytes         # a, d, e
    del d, e


B, S = 2, 16


def _programs(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tree_from_jax(jax.tree.map(np.asarray, jp))
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (B, S)).astype(np.int32)
    return jcfg, cfg, jp, tp, tok


def _walked(fn, *args) -> float:
    return walk(jax.jit(fn).lower(*args).compile().as_text()).flops


def test_qwen3_forward_and_decode_match_hlo_walk():
    jcfg, cfg, jp, tp, tok = _programs("qwen3_8b")
    f32 = torch.float32
    want = _walked(lambda p, t: jlm.forward(p, jcfg, t,
                                            compute_dtype=jnp.float32),
                   jp, tok)
    with cost.Counter() as c:
        lm.forward(tp, cfg, torch.from_numpy(tok), compute_dtype=f32)
    assert abs(c.flops / want - 1) < 1e-6, (c.flops, want)

    caches = jlm.init_caches(jcfg, B, S, dtype=jnp.float32)
    want = _walked(lambda p, t, ca: jlm.decode_step(
        p, jcfg, t, ca, jnp.int32(3), compute_dtype=jnp.float32),
        jp, tok[:, :1], caches)
    tc = lm.init_caches(cfg, B, S, dtype=f32, device="cpu")
    with cost.Counter() as c:
        lm.decode_step(tp, cfg, torch.from_numpy(tok[:, :1]), tc, 3,
                       compute_dtype=f32)
    assert abs(c.flops / want - 1) < 1e-6, (c.flops, want)


def test_internlm2_remat_train_step_matches_hlo_walk():
    jcfg, cfg, jp, tp, tok = _programs("internlm2_1_8b")
    want = _walked(jax_make_train_step(jcfg, remat=True), jp,
                   jax_init_opt_state(jp), {"tokens": tok})
    step = make_train_step(cfg, remat=True)
    with cost.Counter() as c:
        step(tp, init_opt_state(tp), {"tokens": torch.from_numpy(tok)})
    assert abs(c.flops / want - 1) < 1e-6, (c.flops, want)


def test_sharded_product_counts_local_flops_and_one_all_reduce():
    """``Shard(1) @ Shard(0)`` on a fake 4-rank world: each rank multiplies
    its (m, k/4) by (k/4, n) block, and making the partial result whole
    is one all-reduce of the (m, n) result, counted at 2x its bytes."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import fake_world
    m, k, n = 64, 128, 32
    with fake_world(4):
        mesh = init_device_mesh("cpu", (4,))
        a = distribute_tensor(torch.randn(m, k), mesh, [Shard(1)])
        b = distribute_tensor(torch.randn(k, n), mesh, [Shard(0)])
        with cost.Counter() as c, CommDebugMode() as comm:
            (a @ b).redistribute(mesh, [Replicate()])
    assert c.flops == 2 * m * (k // 4) * n
    assert c.coll_counts == {"all-reduce": 1}
    assert c.coll_by_op["all-reduce"] == 2 * m * n * 4
    assert c.coll_bytes == 2 * m * n * 4
    assert comm.get_total_counts() == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_jax(arch):
    assert JAX_ARCH_IDS == ARCH_IDS and list(JAX_SHAPES) == list(SHAPES)
    for name in SHAPES:
        assert cost.model_flops(get_config(arch), SHAPES[name]) \
            == hlo_analysis.model_flops(jax_get_config(arch),
                                        JAX_SHAPES[name])
        assert cost.model_flops(get_config(arch).reduced(), SHAPES[name],
                                n_tokens=7) \
            == hlo_analysis.model_flops(jax_get_config(arch).reduced(),
                                        JAX_SHAPES[name], n_tokens=7)


def test_roofline_fields_and_terms():
    kw = dict(flops=989e12, hbm_bytes=6.7e12, coll_bytes=25e9,
              coll_by_op={"all-reduce": 25e9}, peak_bytes_per_device=1e9)
    r = cost.Roofline(**kw)
    jr = hlo_analysis.Roofline(**kw)
    assert set(r.as_dict()) == set(jr.as_dict())
    assert r.compute_s == 1.0 and r.memory_s == 2.0 and r.collective_s == 0.5
    assert r.bottleneck == "memory"
    assert r.as_dict()["bottleneck"] == "memory"
