#!/usr/bin/env python3
"""Measure the gaps between the port and the JAX package that are not
faults of the port, at configurations no test holds whole.

Run from the repository root, one case at a time::

    python3 tests/torch_port_gaps.py vit4        # CPU, JAX and the port
    python3 tests/torch_port_gaps.py moe         # CPU, JAX and the port
    python3 tests/torch_port_gaps.py xlstm 8     # CPU, JAX and the port
    python3 tests/torch_port_gaps.py xlstm-card  # one GPU, the port only

(about a minute each; ``xlstm 16`` about six).  Like the tests, it
imports both packages where it compares them; the card case imports no
JAX.

* ``vit4``: vit_tiny at full width under ``input_bits=4, weight_bits=4,
  adc_bits=6`` against JAX's compiled model on four input draws (seeds
  0-3, batch 3): the free run's relative logit gap, probability gap and
  argmax agreement, beside the default 8/8/9 config's.
* ``moe``: granite-moe at ``reduced()`` width with its published routing
  (40 experts, top 8) and with the reduced one (4, top 2): JAX's own
  float32 decode steps against its forward over 32 tokens (argmax
  agreement and correlation), and the port's forward against JAX's.
* ``xlstm DEPTH``: xLSTM at its published width (d_model 2048, 4 heads
  of 1024; vocabulary cut to 512) and ``DEPTH`` layers, float32 and
  bfloat16 compute: each package's decode against its forward over 32
  tokens, and the port against JAX.
* ``xlstm-card``: xLSTM-1.3B at full size, bfloat16 weights on the card:
  decode against forward and each against its float32 run at depths 8,
  16, 24 and 48, then the bfloat16 forward with the mLSTM or the sLSTM
  layers computed in float32.

The cases that compare with JAX need it installed (they run on the CPU);
``xlstm-card`` needs a CUDA device and exits 1 without one.
"""

from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

T = 32          # decode steps / tokens of the LM cases


def _corr(a, b) -> float:
    import numpy as np
    return float(np.corrcoef(np.asarray(a, np.float32).ravel(),
                             np.asarray(b, np.float32).ravel())[0, 1])


def vit4() -> None:
    import jax.numpy as jnp
    import numpy as np
    from test_torch_sequence import W4A4_ADC6, _vit_models, _x
    for name, kw in (("default", {}), ("w4a4_adc6", W4A4_ADC6)):
        jm, tm = _vit_models(kw)
        for seed in range(4):
            x = _x(jm.graph, 3, seed=seed)
            ref = np.asarray(jm.run(jnp.asarray(x), logits=True))
            got = tm.run(x, logits=True).numpy()
            prob = np.abs(tm.run(x).numpy()
                          - np.asarray(jm.run(jnp.asarray(x)))).max()
            print(f"vit_tiny {name} seed {seed}: rel "
                  f"{np.abs(got - ref).max() / np.abs(ref).max():.3e}, "
                  f"probs {prob:.3e}, argmax agreement "
                  f"{(got.argmax(1) == ref.argmax(1)).mean():.4f}")


def _jax_lm(jcfg, params, tokens, dtype):
    """JAX's jitted forward and ``T`` decode steps' logits, as numpy."""
    import jax
    import numpy as np
    from repro.models import lm as jlm
    fwd = jax.jit(lambda p, t: jlm.forward(p, jcfg, t, compute_dtype=dtype))
    step = jax.jit(lambda p, t, c, i: jlm.decode_step(
        p, jcfg, t, c, i, compute_dtype=dtype))
    caches = jlm.init_caches(jcfg, tokens.shape[0], T, dtype=dtype)
    outs = []
    for i in range(T):
        lg, caches = step(params, tokens[:, i:i + 1], caches, i)
        outs.append(np.asarray(lg, np.float32))
    return (np.asarray(fwd(params, tokens), np.float32),
            np.concatenate(outs, 1))


def _port_lm(cfg, params, tokens, dtype):
    import numpy as np
    import torch
    from repro_torch.models import lm
    t = torch.from_numpy(tokens)
    fwd = lm.forward(params, cfg, t, compute_dtype=dtype).float().numpy()
    caches = lm.init_caches(cfg, t.shape[0], T, dtype=dtype, device="cpu")
    outs = []
    for i in range(T):
        lg, caches = lm.decode_step(params, cfg, t[:, i:i + 1], caches, i,
                                    compute_dtype=dtype)
        outs.append(lg.float().numpy())
    return fwd, np.concatenate(outs, 1)


def _configs(arch: str, **kw):
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _params(jcfg):
    import jax
    import numpy as np
    from repro.models import lm as jlm
    from repro_torch.convert import tree_from_jax
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return params, tree_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")


def moe() -> None:
    import jax.numpy as jnp
    import numpy as np
    import torch
    for kw in ({}, dict(n_experts=40, experts_per_token=8)):
        jcfg, cfg = _configs("granite_moe_3b_a800m", **kw)
        jp, tp = _params(jcfg)
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, T)).astype(np.int32)
        f, d = _jax_lm(jcfg, jp, tokens, jnp.float32)
        tf, _ = _port_lm(cfg, tp, tokens, torch.float32)
        print(f"granite-moe {cfg.n_experts} experts top "
              f"{cfg.experts_per_token}: JAX decode vs forward agreement "
              f"{(f.argmax(-1) == d.argmax(-1)).mean():.4f} correlation "
              f"{_corr(f, d):.5f}; port forward vs JAX "
              f"{np.abs(tf - f).max() / np.abs(f).max():.2e} of max|logit|")


def xlstm(depth: int) -> None:
    import jax.numpy as jnp
    import numpy as np
    import torch
    jcfg, cfg = _configs("xlstm_1_3b", d_model=2048, n_heads=4,
                         n_layers=depth, xlstm_slstm_every=8,
                         vocab_size=512)
    jp, tp = _params(jcfg)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, T)).astype(np.int32)
    for name, jd, td in (("float32", jnp.float32, torch.float32),
                         ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        f, d = _jax_lm(jcfg, jp, tokens, jd)
        tf, tdec = _port_lm(cfg, tp, tokens, td)
        print(f"xlstm width 2048 depth {depth} {name}: decode vs forward "
              f"JAX correlation {_corr(f, d):.5f} agreement "
              f"{(f.argmax(-1) == d.argmax(-1)).mean():.4f}, port "
              f"{_corr(tf, tdec):.5f} / "
              f"{(tf.argmax(-1) == tdec.argmax(-1)).mean():.4f}; port vs "
              f"JAX forward correlation {_corr(tf, f):.5f}, decode "
              f"{_corr(tdec, d):.5f}")


def xlstm_card() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_port_gaps: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.nvidia_smi())
    full = get_config("xlstm_1_3b")
    gen = torch.Generator(dev).manual_seed(2602)
    params = lm.init_params(full, gen, dtype=torch.bfloat16, device=dev)
    tokens = torch.randint(0, full.vocab_size, (2, T), device=dev,
                           generator=gen)

    def cut(n: int) -> dict:       # the first n // 8 groups of layers
        return {k: cs._tree(lambda t: t[: n // 8], v) if k == "groups"
                else v for k, v in params.items()}

    def corr(a, b) -> float:
        return _corr(a.float().cpu().numpy(), b.float().cpu().numpy())

    for n in (8, 16, 24, 48):
        cfg = dataclasses.replace(full, n_layers=n)
        r = {name: cs.lm_logits(cfg, cut(n), tokens, None, T, dt)
             for name, dt in (("f32", torch.float32),
                              ("bf16", torch.bfloat16))}
        print(f"{n} layers: decode vs forward float32 "
              f"{corr(r['f32'][0], r['f32'][2]):.5f}, bfloat16 "
              f"{corr(r['bf16'][0], r['bf16'][2]):.5f}; bfloat16 vs "
              f"float32 forward {corr(r['bf16'][0], r['f32'][0]):.5f}, "
              f"decode {corr(r['bf16'][2], r['f32'][2]):.5f}")
    ref = lm.forward(params, full, tokens, compute_dtype=torch.float32)
    for which in ("mlstm", "slstm"):
        orig = getattr(L, which)
        setattr(L, which, lambda p, x, c, *a, _o=orig, **k:
                _o(p, x.float(), c, *a, **k).to(x.dtype))
        try:
            got = lm.forward(params, full, tokens,
                             compute_dtype=torch.bfloat16)
        finally:
            setattr(L, which, orig)
        print(f"48 layers, bfloat16 forward with the {which} layers in "
              f"float32: correlation to the float32 forward "
              f"{corr(got, ref):.5f}")
    return 0


def main(argv: list[str]) -> int:
    case = argv[0] if argv else ""
    if case == "vit4":
        vit4()
    elif case == "moe":
        moe()
    elif case == "xlstm" and len(argv) == 2:
        xlstm(int(argv[1]))
    elif case == "xlstm-card":
        return xlstm_card()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
