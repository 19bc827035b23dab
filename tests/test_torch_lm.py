"""The port's LM assembly (``repro_torch.models.lm``) against the JAX
package's, for all ten architectures at ``reduced()``.

Parameters come from JAX's ``init_params(PRNGKey(0))`` and cross with
``convert.tree_from_jax``; tokens and frame embeddings are numpy draws
from a seed.  The JAX reference runs under ``jax.jit`` (the config closed
over, so static), once per architecture, shared through a module-scoped
fixture.  Compute is float32 unless a test says otherwise.
"""

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, SHAPES, all_configs, get_config
from repro_torch.convert import tree_from_jax
from repro_torch.models import lm

B, S = 2, 16          # 16 teacher-forced decode steps over S tokens
# float32 logits against JAX's, relative to max |logit|: matmul and
# reduction orders differ between XLA:CPU and torch (measured <= 1.5e-6)
LOGIT_TOL = 1e-4


# the published group sizes, which reduced() cuts to 2: Zamba2's shared
# attention once every 6 Mamba2 blocks and xLSTM's one sLSTM in 8
GROUPS = {"zamba2_2_7b@6": ("zamba2_2_7b", dict(shared_attn_every=6,
                                                 n_layers=6)),
          "xlstm_1_3b@8": ("xlstm_1_3b", dict(xlstm_slstm_every=8,
                                               n_layers=8))}


def _config(case, get):
    """``case``'s reduced config from ``get`` (either package's
    ``get_config``): an arch id, or a key of ``GROUPS``."""
    arch, kw = GROUPS.get(case, (case, {}))
    return dataclasses.replace(get(arch).reduced(), **kw)


def _max_rel(got, ref) -> float:
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / np.abs(ref).max())


def _reference(arch):
    """JAX's params, inputs, float32 forward / encoder / 16 decode steps
    and bfloat16 forward for ``arch`` (or a ``GROUPS`` case), all
    jitted."""
    cfg = _config(arch, jax_get_config)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(ARCH_IDS.index(GROUPS.get(arch, (arch,))[0]))
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
              .astype(np.float32) if cfg.is_encdec else None)

    def fwd(p, t, e, dtype):
        return jlm.forward(p, cfg, t, encoder_input=e, compute_dtype=dtype)

    def decode(p, t, e):
        caches = jlm.init_caches(cfg, B, S, dtype=jnp.float32)
        states = jlm.encode(p, cfg, e, jnp.float32) if e is not None else None

        def step(c, i):
            tok = jax.lax.dynamic_slice_in_dim(t, i, 1, 1)
            lg, c = jlm.decode_step(p, cfg, tok, c, i,
                                    encoder_states=states,
                                    compute_dtype=jnp.float32)
            return c, lg[:, 0]
        _, lgs = jax.lax.scan(step, caches, jnp.arange(S))
        return lgs.transpose(1, 0, 2), states

    fwd_j = jax.jit(fwd, static_argnums=3)
    dec, states = jax.jit(decode)(params, tokens, frames)
    return dict(
        params=jax.tree.map(np.asarray, params), tokens=tokens,
        frames=frames, forward=np.asarray(fwd_j(params, tokens, frames,
                                                jnp.float32)),
        forward_bf16=np.asarray(fwd_j(params, tokens, frames, jnp.bfloat16),
                                np.float32),
        decode=np.asarray(dec),
        states=None if states is None else np.asarray(states))


@pytest.fixture(scope="module")
def refs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _reference(arch)
        return cache[arch]
    return get


def _port(ref):
    params = tree_from_jax(ref["params"], device="cpu")
    tokens = torch.from_numpy(ref["tokens"])
    frames = (None if ref["frames"] is None
              else torch.from_numpy(ref["frames"]))
    return params, tokens, frames


def test_configs_are_the_jax_packages():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert SHAPES.keys() == {"train_4k", "prefill_32k", "decode_32k",
                             "long_500k"}
    for arch, cfg in all_configs().items():
        ref = jax_get_config(arch)
        assert repr(cfg) == repr(ref)
        assert repr(cfg.reduced()) == repr(ref.reduced())
        assert (cfg.padded_vocab, cfg.resolved_head_dim, cfg.is_encdec,
                cfg.supports_long_context) == \
            (ref.padded_vocab, ref.resolved_head_dim, ref.is_encdec,
             ref.supports_long_context)
    assert get_config("qwen3-8b") is get_config("qwen3_8b")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_tree_shapes_dtypes_and_scales(arch, refs):
    """Same tree, shapes and dtypes as JAX's ``init_params`` (float32 and
    bfloat16); constant leaves equal, random leaves within 20% of JAX's
    standard deviation (draws cannot be reproduced)."""
    jcfg = jax_get_config(arch).reduced()
    ref = dict(_leaves(refs(arch)["params"]))
    got = dict(_leaves(lm.init_params(get_config(arch).reduced(),
                                      torch.Generator().manual_seed(0),
                                      device="cpu")))
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if r.min() == r.max():
            assert (g == r).all(), name
        else:
            assert abs(g.std() / r.std() - 1) < 0.2, (name, g.std(), r.std())
    shapes = jax.eval_shape(lambda k: jlm.init_params(jcfg, k, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    bf = dict(_leaves(lm.init_params(get_config(arch).reduced(),
                                     torch.Generator().manual_seed(0),
                                     dtype=torch.bfloat16, device="cpu")))
    for name, r in _leaves(shapes):
        assert tuple(bf[name].shape) == r.shape, name
        assert str(bf[name].dtype).removeprefix("torch.") == str(r.dtype)


class _LiveBytes(TorchDispatchMode):
    """The most bytes that the tensors made under it held at once (views
    of one buffer counted once)."""

    def __init__(self):
        super().__init__()
        self.refs, self.peak = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.refs.append(weakref.ref(t))
        live = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in (r() for r in self.refs) if t is not None}
        self.peak = max(self.peak, sum(live.values()))
        return out


@pytest.mark.parametrize("arch", ["phi3_medium_14b", "xlstm_1_3b"])
def test_init_params_casts_leaf_by_leaf(arch):
    """bfloat16 parameters are drawn in float32 and cast one leaf at a
    time: the peak is the float32 tree plus one leaf's copy, not the tree
    plus a whole copy (which does not fit one 80 GB card at
    Phi-3-medium's full size); the values are the float32 draws'."""
    cfg = get_config(arch).reduced()
    f32 = lm.init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    leaves = [t for _, t in _leaves(f32)]
    with _LiveBytes() as mode:
        bf = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.bfloat16, device="cpu")
    f32_bytes = sum(t.nbytes for t in leaves)
    assert mode.peak <= f32_bytes + max(t.nbytes for t in leaves) // 2
    for (name, a), (_, b) in zip(_leaves(f32), _leaves(bf)):
        assert b.dtype == (torch.bfloat16 if a.dtype == torch.float32
                           else a.dtype), name
        assert torch.equal(b, a.to(b.dtype)), name


def test_init_params_without_device_raises_on_a_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(get_config("qwen3_8b").reduced(), torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_caches(get_config("qwen3_8b").reduced(), 1, 4)


@pytest.mark.parametrize("arch", [*ARCH_IDS, *GROUPS])
def test_forward_matches_jax(arch, refs):
    ref = refs(arch)
    params, tokens, frames = _port(ref)
    cfg = _config(arch, get_config)
    got = lm.forward(params, cfg, tokens, encoder_input=frames,
                     compute_dtype=torch.float32)
    assert got.shape == (B, S, cfg.padded_vocab)
    assert _max_rel(got, ref["forward"]) <= LOGIT_TOL


@pytest.mark.parametrize("arch", [*ARCH_IDS, *GROUPS])
def test_teacher_forced_decode_matches_jax(arch, refs):
    """16 ``decode_step``s over the same tokens, the caches in float32."""
    ref = refs(arch)
    params, tokens, frames = _port(ref)
    cfg = _config(arch, get_config)
    states = None
    if frames is not None:
        states = lm.encode(params, cfg, frames, torch.float32)
        assert _max_rel(states, ref["states"]) <= LOGIT_TOL
    caches = lm.init_caches(cfg, B, S, dtype=torch.float32, device="cpu")
    before = {k: v.clone() for k, v in _leaves(caches)}
    outs = []
    for i in range(S):
        lg, new = lm.decode_step(params, cfg, tokens[:, i:i + 1], caches, i,
                                 encoder_states=states,
                                 compute_dtype=torch.float32)
        if i == 0:      # the step returns new state and leaves its input
            assert all(torch.equal(v, before[k]) for k, v in _leaves(caches))
        caches = new
        outs.append(lg[:, 0])
    assert _max_rel(torch.stack(outs, 1), ref["decode"]) <= LOGIT_TOL


# bfloat16 forward against JAX's bfloat16 forward: the two round in
# different places (XLA fuses elementwise chains in float32), so only the
# correlation is held (measured 0.9954 for granite_moe, whose top-k
# routing flips, and >= 0.9997 for the others); argmax agreement (printed
# with -s) was 0.9375-1.0 across the ten archs on this test's inputs.
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_forward_correlates_with_jax(arch, refs):
    ref = refs(arch)
    params, tokens, frames = _port(ref)
    got = lm.forward(params, get_config(arch).reduced(), tokens,
                     encoder_input=frames).float().numpy()
    want = ref["forward_bf16"]
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"{arch}: bf16 correlation {corr:.5f}, argmax agreement "
          f"{agree:.4f}")
    assert corr >= 0.99, corr
