"""The port's LM training step (``repro_torch.train.step``, ``remat`` in
``models.lm``) on the CPU against the JAX package's, for the ten
architectures at ``reduced()``.

Parameters come from JAX's ``init_params(PRNGKey(0))`` and cross with
``convert.tree_from_jax``; tokens and frame embeddings are numpy draws
from a seed.  The JAX side runs under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import tree_from_jax
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import lm
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.step import (cross_entropy, make_grad_fn,
                                    make_train_step)
from repro_torch.tree import tree_from_items, tree_items

B, S = 2, 16
# float32 compute against jitted JAX: the loss to 1e-5 relative, each
# gradient leaf to 1e-4 of that leaf's max |grad| (matmul and reduction
# orders differ between XLA:CPU and torch, as for the logits)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
# bfloat16 compute: the two packages round in different places, so the
# gradients are held by correlation, as the bf16 logits are
BF16_CORR = 0.99


def _inputs(arch):
    cfg = jax_get_config(arch).reduced()
    params = jax.tree.map(np.asarray,
                          jlm.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(100 + ARCH_IDS.index(arch))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return cfg, params, batch


def _port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _items(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_items(tree) -> dict:
    return {k: v.float().numpy() for k, v in tree_items(tree)}


def _port_f32_value_and_grad(cfg, params, batch, remat=False):
    leaves = {k: v.detach().requires_grad_() for k, v in tree_items(params)}
    logits = lm.forward(tree_from_items(params, leaves), cfg, batch["tokens"],
                        encoder_input=batch.get("frames"),
                        compute_dtype=torch.float32, remat=remat)
    loss = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                         cfg.vocab_size)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.item(), {k: np.zeros(v.shape, np.float32) if g is None
                         else g.numpy()
                         for (k, v), g in zip(leaves.items(), grads)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_f32_loss_and_grads_match_jax(arch):
    jcfg, params, batch = _inputs(arch)

    def loss_fn(p, b):
        logits = jlm.forward(p, jcfg, b["tokens"],
                             encoder_input=b.get("frames"),
                             compute_dtype=jnp.float32)
        return jstep.cross_entropy(logits[:, :-1], b["tokens"][:, 1:],
                                   jcfg.vocab_size)
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
    want = _items(jg)
    loss, got = _port_f32_value_and_grad(
        get_config(arch).reduced(), tree_from_jax(params),
        _port_batch(batch))
    assert abs(loss / float(jl) - 1) <= LOSS_TOL, (loss, float(jl))
    assert got.keys() == want.keys()
    worst = 0.0
    for k, w in want.items():
        scale = np.abs(w).max()
        gap = np.abs(got[k] - w).max()
        assert gap <= GRAD_TOL * scale, (k, gap, scale)
        worst = max(worst, gap / scale if scale else 0.0)
    print(f"{arch}: loss {loss:.6f} vs {float(jl):.6f}, worst leaf "
          f"{worst:.2e} of its max |grad|")


def _corr(a: dict, b: dict) -> float:
    x = np.concatenate([a[k].ravel() for k in sorted(b)])
    y = np.concatenate([b[k].ravel() for k in sorted(b)])
    return float(np.corrcoef(x, y)[0, 1])


# One bfloat16 train step against JAX's jitted step, InternLM2 (dense)
# and Mixtral (MoE): loss and grad_norm to 2e-2 relative (measured 4e-5
# and 9.4e-4 for InternLM2; 5.3e-5 and 1.2e-2 for Mixtral, whose top-k
# routing flips), the gradients by correlation (measured 0.9998 and
# 0.9970); microbatches=2 against the mean of JAX's gradients over the
# two halves, as its scan takes them
@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x22b"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_bf16_train_step_matches_jax(arch, microbatches):
    jcfg, params, _ = _inputs(arch)
    batch = {"tokens": np.asarray(JaxPipeline(jcfg.vocab_size, 4, S,
                                              seed=3).batch_at(0)["tokens"])}
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10)
    jfn = jax.jit(jstep.make_train_step(
        jcfg, jopt.OptimizerConfig(lr=1e-3, warmup_steps=10),
        microbatches=microbatches, remat=False))
    _, jstate, jm = jfn(params, jopt.init_opt_state(params), batch)
    jgrad = jax.jit(jax.grad(jstep.make_loss_fn(jcfg, remat=False)))
    halves = [{"tokens": t} for t in np.split(batch["tokens"],
                                               microbatches)]
    want = {k: sum(_items(jgrad(params, h))[k] for h in halves)
            / microbatches for k in _items(params)}

    cfg = get_config(arch).reduced()
    tp, tb = tree_from_jax(params), _port_batch(batch)
    new_p, state, m = make_train_step(cfg, opt, microbatches=microbatches,
                                      remat=False)(tp, init_opt_state(tp),
                                                   tb)
    _, grads = make_grad_fn(cfg, microbatches, remat=False)(tp, tb)
    corr = _corr(_port_items(grads), want)
    loss_gap = abs(m["loss"].item() / float(jm["loss"]) - 1)
    norm_gap = abs(m["grad_norm"].item() / float(jm["grad_norm"]) - 1)
    print(f"{arch} mb{microbatches}: loss {m['loss'].item():.5f} vs "
          f"{float(jm['loss']):.5f}, grad_norm {m['grad_norm'].item():.5f} "
          f"vs {float(jm['grad_norm']):.5f}, gradient correlation "
          f"{corr:.6f}")
    assert corr >= BF16_CORR
    assert loss_gap <= 2e-2 and norm_gap <= 2e-2, (loss_gap, norm_gap)
    assert m["lr"].item() == float(jm["lr"])
    assert int(state["step"]) == int(jstate["step"]) == 1
    for t in (m["loss"], m["grad_norm"], m["lr"]):
        assert t.shape == () and t.dtype == torch.float32
    # the step is functional: its inputs are left as they were
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_items(tp), tree_items(tree_from_jax(params))))
    assert not any(torch.equal(a, b) for (_, a), (_, b) in
                   zip(tree_items(new_p), tree_items(tp))
                   if a.numel() > 1)


@pytest.mark.parametrize("arch", ["qwen3_8b", "granite_moe_3b_a800m",
                                  "qwen2_vl_72b", "zamba2_2_7b",
                                  "xlstm_1_3b", "whisper_medium"])
def test_remat_equals_no_remat(arch):
    """Every family (dense, moe, vlm, hybrid, ssm, audio): the loss and
    every gradient leaf with ``remat=True`` equal ``remat=False``'s, in
    float32 compute and in bfloat16 (``make_grad_fn``)."""
    _, params, batch = _inputs(arch)
    cfg = get_config(arch).reduced()
    tp, tb = tree_from_jax(params), _port_batch(batch)
    l0, g0 = _port_f32_value_and_grad(cfg, tp, tb, remat=False)
    l1, g1 = _port_f32_value_and_grad(cfg, tp, tb, remat=True)
    assert l0 == l1
    assert all(np.array_equal(g0[k], g1[k]) for k in g0)
    a = make_grad_fn(cfg, remat=False)(tp, tb)
    b = make_grad_fn(cfg, remat=True)(tp, tb)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(tree_items(a[1]), tree_items(b[1])))


def test_loss_goes_down():
    """The JAX package's ``test_loss_goes_down`` on the port."""
    cfg = get_config("internlm2_1_8b").reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    pipe = TokenPipeline(cfg.vocab_size, batch=8, seq_len=32, seed=3,
                         device="cpu")
    step = make_train_step(cfg, OptimizerConfig(lr=1e-2, warmup_steps=5),
                           remat=False)
    opt = init_opt_state(params)
    losses = []
    for i, batch in zip(range(50), pipe):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses
