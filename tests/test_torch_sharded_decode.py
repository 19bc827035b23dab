"""The sequence-sharded flash decode and the DTensor paths of the LM
stack, on real gloo worlds of CPU ranks.

* On a 1-rank mesh the port's ``_flash_decode_seqsharded`` (through
  ``layers.attention`` with rules and a mesh) against the JAX package's
  on a 1x1 mesh, the same weights and inputs: 5 steps as in
  ``tests/test_sharding_paths.py``, a GQA and an MHA config.
* On 2- and 4-rank meshes (the cache's sequence split on "model", so the
  all-reduce combine is real) against the port's plain decode: within
  2e-4, the JAX package's own tolerance, with caches equal.
* On a (2, 2) mesh, reduced archs with DTensor parameters against the
  plain path: forward, decode steps, and a remat train step's loss and
  gradients.

The ranks are spawned processes meeting through a ``FileStore`` under
``tmp_path`` (no port); every process group is destroyed when its case
ends.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_dist_cases as cases
from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.sharding import context as jctx
from repro.sharding.rules import ShardingRules as JaxRules
from repro_torch.configs import get_config
from repro_torch.convert import tree_from_jax
from repro_torch.models import layers as L
from repro_torch.sharding import context as shctx
from repro_torch.sharding.rules import ShardingRules

SEQ_TOL = 2e-4          # the JAX package's seq-sharded decode tolerance
JAX_TOL = 1e-5          # port against JAX on one rank
MODEL_TOL = 1e-4        # DTensor path against plain, relative to the max


def _spawn(case: str, world: int, mesh_shape: tuple, tmp_path) -> list:
    mp.spawn(cases.run, args=(world, str(tmp_path / "store"), case,
                              mesh_shape, str(tmp_path)),
             nprocs=world, join=True)
    return [torch.load(tmp_path / f"{r}.pt") for r in range(world)]


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store1"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["gqa", "mha"])
def test_seqsharded_decode_matches_jax_on_one_rank(kind, one_rank):
    from torch.distributed.device_mesh import init_device_mesh
    jcfg = jax_get_config("qwen3_8b").reduced()
    if kind == "mha":
        jcfg = dataclasses.replace(jcfg, n_kv_heads=jcfg.n_heads)
    cfg = get_config("qwen3_8b").reduced()
    cfg = dataclasses.replace(cfg, n_kv_heads=jcfg.n_kv_heads)
    jrules = JaxRules(jcfg, model_size=1, data_size=1)
    jrules.mesh = jax.make_mesh((1, 1), ("data", "model"))
    rules = ShardingRules(cfg, model_size=1, data_size=1)
    rules.mesh = init_device_mesh("cpu", (1, 1),
                                  mesh_dim_names=("data", "model"))
    jparams = JL.init_attention(jax.random.PRNGKey(0), jcfg.d_model,
                                jcfg.n_heads, jcfg.n_kv_heads,
                                jcfg.resolved_head_dim, jcfg.qk_norm)
    params = tree_from_jax(jax.tree.map(np.asarray, jparams))
    b, smax = 2, 64
    jc = JL.init_kv_cache(b, smax, jcfg, jnp.float32)
    tc = L.init_kv_cache(b, smax, cfg, torch.float32, device="cpu")
    rng = np.random.default_rng(10)
    with jrules.mesh, jctx.use_rules(jrules):
        jstep = jax.jit(lambda x, pos, c: JL.attention(jparams, x, pos, jcfg,
                                                       kv_cache=c))
    for i in range(cases.STEPS):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        with jrules.mesh, jctx.use_rules(jrules):
            jout, jc = jstep(jnp.asarray(x), jnp.full((b, 1), i), jc)
        with shctx.use_rules(rules):
            out, tc = L.attention(params, torch.from_numpy(x),
                                  torch.full((b, 1), i), cfg, kv_cache=tc)
        assert type(out).__name__ == "DTensor"     # the branch was taken
        np.testing.assert_allclose(out.full_tensor().numpy(),
                                   np.asarray(jout), rtol=0, atol=JAX_TOL)
        # the cache update is a copy, but the k/v it copies come from
        # float32 projections that XLA and torch sum in other orders
        # (1-ulp differences): held to the output's tolerance
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].full_tensor().numpy(),
                                       np.asarray(jc[k]), rtol=0,
                                       atol=JAX_TOL)
        assert int(tc["index"]) == int(jc["index"]) == i + 1


@pytest.mark.parametrize("world", [2, 4])
def test_seqsharded_decode_matches_plain_decode(world, tmp_path):
    results = _spawn("seqsharded_decode", world, (1, world), tmp_path)
    for rank, res in enumerate(results):
        for kind, r in res.items():
            assert len(r["gaps"]) == cases.STEPS
            assert max(r["gaps"]) <= SEQ_TOL, (rank, kind, r["gaps"])
            assert r["caches_equal"], (rank, kind)


def test_dtensor_model_matches_plain_on_2x2(tmp_path):
    """float32: forward and decode logits, loss and every gradient leaf
    (measured <= 2e-6 of its max; sums over shards in other orders);
    the bfloat16 step at 2 microbatches by loss and gradient correlation
    (the repo's bfloat16 yardstick, 0.99; MoE routing flips)."""
    results = _spawn("sharded_model", 4, (2, 2), tmp_path)
    for rank, res in enumerate(results):
        assert set(res) == set(cases.MODEL_ARCHS)
        for arch, r in res.items():
            for part in ("forward", "decode", "grads"):
                assert r[part] <= MODEL_TOL, (rank, arch, part, r)
            assert r["loss"] <= 1e-5, (rank, arch, r)
            assert r["mb_loss"] <= 1e-3 and r["mb_corr"] >= 0.99, (rank,
                                                                   arch, r)
