"""Cases the port's DTensor paths run on a real gloo world of CPU ranks,
for ``tests/test_torch_sharded_decode.py``.  Each rank runs ``run`` in
its own spawned process (imported by name, so this module imports no
JAX); ranks meet through a ``FileStore`` and write what they found to
``out_dir/<rank>.pt``.  Every rank draws the same inputs from seeds.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

STEPS = 5                  # decode steps, as the JAX package's test
B, SMAX = 2, 64


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def decode_cfgs():
    """qwen3 reduced (GQA: 4 heads over 2 kv heads) and the same with one
    kv head per head."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3_8b").reduced()
    return {"gqa": cfg, "mha": dataclasses.replace(cfg, n_kv_heads=4)}


def decode_inputs(cfg):
    g = torch.Generator().manual_seed(0)
    from repro_torch.models import layers as L
    params = L.init_attention(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.resolved_head_dim, cfg.qk_norm,
                              device="cpu")
    xs = [torch.randn((B, 1, cfg.d_model), generator=g)
          for _ in range(STEPS)]
    return params, xs


def seqsharded_decode(mesh_shape):
    """``STEPS`` decode steps of one attention layer through the
    sequence-sharded flash decode (cache sequence on the model axis)
    against the plain decode on this rank: max |out gap| per step and
    whether the caches are equal."""
    from repro_torch.models import layers as L
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.rules import ShardingRules
    mesh = _mesh(mesh_shape)
    out = {}
    for name, cfg in decode_cfgs().items():
        params, xs = decode_inputs(cfg)
        rules = ShardingRules(cfg, data_size=mesh_shape[0],
                              model_size=mesh_shape[1])
        rules.mesh = mesh
        ref = L.init_kv_cache(B, SMAX, cfg, torch.float32, device="cpu")
        fd = dict(ref)
        gaps, equal = [], True
        for i, x in enumerate(xs):
            pos = torch.full((B, 1), i)
            o_ref, ref = L.attention(params, x, pos, cfg, kv_cache=ref)
            with shctx.use_rules(rules):
                o_fd, fd = L.attention(params, x, pos, cfg, kv_cache=fd)
            gaps.append((o_fd.full_tensor() - o_ref).abs().max().item())
            equal &= all(torch.equal(fd[k].full_tensor(), ref[k])
                         for k in ("k", "v"))
            equal &= int(fd["index"]) == int(ref["index"])
        out[name] = dict(gaps=gaps, caches_equal=equal)
    return out


MODEL_ARCHS = ("qwen3_8b", "mixtral_8x22b", "xlstm_1_3b")


def _rel(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def sharded_model(mesh_shape):
    """Reduced archs with DTensor parameters on a (data, model) mesh
    against the plain path on this rank, float32 compute: forward
    logits, three decode steps (caches sharded by ``cache_specs``), the
    loss and gradients of the remat forward, and the bfloat16 train step's
    gradients at 2 microbatches (their correlation)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.rules import ShardingRules, distribute
    from repro_torch.train.step import make_grad_fn
    from repro_torch.tree import tree_items
    mesh = _mesh(mesh_shape)
    out = {}
    for arch in MODEL_ARCHS:
        cfg = get_config(arch).reduced()
        g = torch.Generator().manual_seed(1)
        params = lm.init_params(cfg, g, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                               dtype=torch.int32)
        rules = ShardingRules(cfg, data_size=mesh_shape[0],
                              model_size=mesh_shape[1])
        rules.mesh = mesh
        dparams = distribute(params, rules.param_specs(params), mesh)
        dtok = distribute(tokens, rules.tokens_spec(4), mesh)
        f32 = torch.float32
        r = {}
        want = lm.forward(params, cfg, tokens, compute_dtype=f32)
        with shctx.use_rules(rules):
            got = lm.forward(dparams, cfg, dtok, compute_dtype=f32)
        r["forward"] = _rel(got.full_tensor(), want)

        caches = lm.init_caches(cfg, 4, 16, dtype=f32, device="cpu")
        dcaches = distribute(caches, rules.cache_specs(caches, 4), mesh)
        worst = 0.0
        for i in range(3):
            lw, caches = lm.decode_step(params, cfg, tokens[:, i:i + 1],
                                        caches, i, compute_dtype=f32)
            with shctx.use_rules(rules):
                lg, dcaches = lm.decode_step(dparams, cfg,
                                             dtok[:, i:i + 1], dcaches, i,
                                             compute_dtype=f32)
            worst = max(worst, _rel(lg.full_tensor(), lw))
        r["decode"] = worst

        # float32 loss and gradients of the remat forward (the logits
        # constrained as the train step does)
        from repro_torch.train.step import _value_and_grad, cross_entropy

        def loss_fn(spec):
            def fn(p, b):
                logits = lm.forward(p, cfg, b["tokens"], compute_dtype=f32,
                                    remat=True)
                if spec is not None:
                    logits = shctx.constrain(logits, spec)
                return cross_entropy(logits[:, :-1], b["tokens"][:, 1:],
                                     cfg.vocab_size)
            return fn
        loss, grads = _value_and_grad(loss_fn(None))(params,
                                                     {"tokens": tokens})
        with shctx.use_rules(rules):
            dloss, dgrads = _value_and_grad(loss_fn(rules.logits_spec()))(
                dparams, {"tokens": dtok})
        r["loss"] = abs(dloss.full_tensor().item() / loss.item() - 1)
        want_g = dict(tree_items(grads))
        r["grads"] = max(
            ((t.full_tensor() - want_g[k]).abs().max()
             / want_g[k].abs().max().clamp_min(1e-30)).item()
            for k, t in tree_items(dgrads))
        # the bfloat16 train step's gradients at 2 microbatches
        loss2, grads2 = make_grad_fn(cfg, 2, remat=True)(params,
                                                         {"tokens": tokens})
        with shctx.use_rules(rules):
            dloss2, dgrads2 = make_grad_fn(
                cfg, 2, remat=True, logits_spec=rules.logits_spec())(
                    dparams, {"tokens": dtok})
        r["mb_loss"] = abs(dloss2.full_tensor().item() / loss2.item() - 1)
        a = torch.cat([t.full_tensor().flatten() for _, t in
                       tree_items(dgrads2)])
        b = torch.cat([t.flatten() for _, t in tree_items(grads2)])
        r["mb_corr"] = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
        out[arch] = r
    return out


CASES = {"seqsharded_decode": seqsharded_decode,
         "sharded_model": sharded_model}


def run(rank: int, world: int, store: str, case: str, mesh_shape: tuple,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        result = CASES[case](mesh_shape)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
