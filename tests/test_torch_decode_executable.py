"""The compiled LM decode step (``serve.step.compile_decode_step``) on the
CPU.

On a CUDA device the step is captured once per key as a CUDA graph and
replayed (``DecodeExecutable``), as the JAX serving entry points call
``jax.jit(make_decode_step(cfg))``.  What can be held here: the step
makes no host sync, no tensor sized by the data and no CPU tensor for
any arch (a dispatch mode over a step on the ``meta`` device); the key;
a replay's bookkeeping over a stand-in graph that runs the eager step on
the executable's static buffers, as a replay does (caches copied in only
when foreign, fresh outputs, one executable per key, a mesh refused);
and that the CPU path is the eager step with nothing cached.  The
capture itself runs on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phases 21 (d), 24, 26 (b) and 28).
"""

import dataclasses
import types

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import lm
from repro_torch.serve.step import (CompiledDecodeStep, DecodeExecutable,
                                    _set_position, compile_decode_step,
                                    decode_key, make_decode_step)
from repro_torch.sharding import context as shctx
from repro_torch.tree import tree_items, tree_leaves, tree_map

from torch_capture import CaptureSafety

B = 2
# one arch per family: dense, moe, hybrid, ssm, audio
FAMILIES = ("qwen3_8b", "mixtral_8x22b", "zamba2_2_7b", "xlstm_1_3b",
            "whisper_medium")


def _inputs(arch: str, max_len: int, seed: int = 0, **replace):
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    gen = torch.Generator().manual_seed(seed)
    params = lm.init_params(cfg, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, max_len), generator=gen,
                           dtype=torch.int32)
    enc = (torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen)
           .to(torch.bfloat16) if cfg.is_encdec else None)
    return cfg, params, tokens, enc


# ---------------------------------------------------------------------------
# capture safety: every arch's step on the meta device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_is_capture_safe(arch):
    """``make_decode_step`` on ``meta`` tensors under ``CaptureSafety``
    (batch 2, the position a 0-d int32 device tensor past the window of
    an arch that has one, so the ring wraps): every op can be captured,
    and the outputs have the shapes of the caches it was given."""
    cfg, params, _, enc = _inputs(arch, 1)
    max_len = 80
    position = 70 if cfg.sliding_window else max_len - 1
    assert not cfg.sliding_window or position > cfg.sliding_window
    params = tree_map(lambda t: t.to("meta"), params)
    caches = lm.init_caches(cfg, B, max_len, device="meta")
    token = torch.zeros((B, 1), dtype=torch.int32, device="meta")
    pos = torch.full((), position, dtype=torch.int32, device="meta")
    enc = None if enc is None else enc.to("meta")
    mode = CaptureSafety()
    with mode:
        nxt, logits, new = make_decode_step(cfg)(params, token, caches, pos,
                                                 encoder_states=enc)
    assert mode.ops > 0
    assert nxt.shape == (B, 1) and nxt.dtype == torch.int32
    assert logits.shape == (B, 1, cfg.padded_vocab)
    assert [(p, t.shape, t.dtype) for p, t in tree_items(new)] == \
        [(p, t.shape, t.dtype) for p, t in tree_items(caches)]


# ---------------------------------------------------------------------------
# the key
# ---------------------------------------------------------------------------

def test_decode_key_fields():
    """Batch, cache leaves (path, shape, dtype), compute dtype, encoder
    states and the params tree by its leaves' memory; not the position."""
    cfg, params, tokens, _ = _inputs("qwen3_8b", 8)
    caches = lm.init_caches(cfg, B, 8, device="cpu")
    tok = tokens[:, :1]
    key = decode_key(params, tok, caches, torch.bfloat16)
    assert key[0] == B
    assert key[1] == tuple((p, tuple(t.shape), t.dtype)
                           for p, t in tree_items(caches))
    assert key[2] == torch.bfloat16 and key[3] is None
    assert [p for p, *_ in key[4]] == [p for p, _ in tree_items(params)]
    assert decode_key(params, tok.clone(), lm.init_caches(
        cfg, B, 8, device="cpu"), torch.bfloat16) == key
    others = [
        decode_key(params, tokens[:1, :1], lm.init_caches(
            cfg, 1, 8, device="cpu"), torch.bfloat16),
        decode_key(params, tok, lm.init_caches(cfg, B, 9, device="cpu"),
                   torch.bfloat16),
        decode_key(params, tok, lm.init_caches(
            cfg, B, 8, dtype=torch.float32, device="cpu"), torch.bfloat16),
        decode_key(params, tok, caches, torch.float32),
        decode_key(params, tok, caches, torch.bfloat16,
                   torch.zeros((B, 4, cfg.d_model), dtype=torch.bfloat16)),
        decode_key(tree_map(torch.clone, params), tok, caches,
                   torch.bfloat16),
    ]
    assert len({key, *others}) == len(others) + 1


# ---------------------------------------------------------------------------
# a replay's bookkeeping over a stand-in graph
# ---------------------------------------------------------------------------

class _EagerGraph:
    """Stands in for a captured graph: a replay runs the eager step on the
    executable's static buffers, writes its static outputs and copies the
    new caches into its static caches, as the captured graph does."""

    def __init__(self, step, exe):
        self.step, self.exe, self.replays = step, exe, 0

    def replay(self):
        e = self.exe
        nxt, logits, new = self.step(e.params, e.token, e.caches, e.position,
                                     encoder_states=e.encoder_states)
        e.next_tok.copy_(nxt)
        e.logits.copy_(logits)
        for dst, src in zip(tree_leaves(e.caches), tree_leaves(new)):
            dst.copy_(src)
        self.replays += 1


class _StandIn(CompiledDecodeStep):
    """``CompiledDecodeStep`` taking its CUDA path on the CPU, each
    executable over an ``_EagerGraph``, each capture in a pool of its own
    index unless one is given."""

    def _captures(self, device):
        return True

    def _capture(self, params, token, caches, position, encoder_states,
                 pool):
        pos = torch.zeros((), dtype=torch.int32)
        _set_position(pos, position)
        exe = DecodeExecutable(
            graph=None, params=params, token=token.to(torch.int32).clone(),
            position=pos, caches=tree_map(torch.clone, caches),
            encoder_states=(None if encoder_states is None
                            else encoder_states.clone()),
            next_tok=torch.zeros((token.shape[0], 1), dtype=torch.int32),
            logits=None, pool=pool or (len(self.executables), 0),
            capture_s=0.0)
        _, logits, _ = self.step(params, exe.token, exe.caches, pos,
                                 encoder_states=exe.encoder_states)
        exe.logits = torch.empty_like(logits)
        exe.graph = _EagerGraph(self.step, exe)
        return exe


def _eager_loop(cfg, params, tokens, enc, steps, caches):
    """``steps`` teacher-forced eager steps: each step's (next_tok,
    logits) and the last caches."""
    step = make_decode_step(cfg)
    outs = []
    for i in range(steps):
        nxt, logits, caches = step(params, tokens[:, i:i + 1], caches, i,
                                   encoder_states=enc)
        outs.append((nxt, logits))
    return outs, caches


# (arch, config fields replaced, steps): each family, and Mixtral with its
# window cut to 8 decoding past it through the ring buffer
REPLAY_CASES = {a: (a, {}, 8) for a in FAMILIES}
REPLAY_CASES["mixtral ring"] = ("mixtral_8x22b", dict(sliding_window=8), 20)


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_replays_equal_the_eager_step(case):
    """A teacher-forced loop through the compiled step over the stand-in
    graph: one executable; every step's ids, logits and the last caches
    bit for bit the eager step's; int and tensor positions share a key;
    each answer is its own tensor (kept answers do not move); the caches
    returned are the executable's own, passed back without a copy, while
    the caches first given are left as they were."""
    arch, replace, steps = REPLAY_CASES[case]
    cfg, params, tokens, enc = _inputs(arch, steps, seed=1, **replace)
    init = lm.init_caches(cfg, B, steps, device="cpu")
    want, want_caches = _eager_loop(cfg, params, tokens, enc, steps, init)
    kept = tree_map(torch.clone, init)
    step = _StandIn(cfg)
    caches, got = init, []
    for i in range(steps):
        position = i if i % 2 else torch.tensor(i, dtype=torch.int32)
        exe = next(iter(step.executables.values()), None)
        versions = None if exe is None else [t._version for t in
                                             tree_leaves(exe.caches)]
        nxt, logits, caches = step(params, tokens[:, i:i + 1], caches,
                                   position, encoder_states=enc)
        exe = next(iter(step.executables.values()))
        assert caches is exe.caches
        assert nxt.data_ptr() != exe.next_tok.data_ptr()
        assert logits.data_ptr() != exe.logits.data_ptr()
        if versions is not None:      # the replay's copy-back, no copy-in
            assert [t._version for t in tree_leaves(caches)] == \
                [v + 1 for v in versions]
        got.append((nxt, logits))
    assert len(step.executables) == 1 and exe.graph.replays == steps
    for i, ((gn, gl), (wn, wl)) in enumerate(zip(got, want)):
        assert torch.equal(gn, wn) and torch.equal(gl, wl), i
    for (p, g), (_, w) in zip(tree_items(caches), tree_items(want_caches)):
        assert torch.equal(g, w), p
    for (p, g), (_, w) in zip(tree_items(init), tree_items(kept)):
        assert torch.equal(g, w), p


def test_foreign_caches_are_copied_in_and_other_params_get_a_key():
    """Caches that are not the executable's own (a fresh round, or an
    eager loop's) are copied in: the replay continues from them, equal to
    the eager step.  A second params tree of the same shapes gets its own
    executable, in the first one's pool; the first key replays on."""
    cfg, params, tokens, _ = _inputs("qwen3_8b", 6, seed=2)
    step = _StandIn(cfg)
    eager = make_decode_step(cfg)
    init = lm.init_caches(cfg, B, 6, device="cpu")
    _, mid = _eager_loop(cfg, params, tokens, None, 3, init)
    step(params, tokens[:, :1], init, 0)
    exe = step.executables[decode_key(params, tokens[:, :1], init,
                                      torch.bfloat16)]
    versions = [t._version for t in tree_leaves(exe.caches)]
    nxt, logits, caches = step(params, tokens[:, 3:4], mid, 3)
    assert [t._version for t in tree_leaves(caches)] == \
        [v + 2 for v in versions]
    w_nxt, w_logits, w_caches = eager(params, tokens[:, 3:4], mid, 3)
    assert torch.equal(nxt, w_nxt) and torch.equal(logits, w_logits)
    assert all(torch.equal(g, w) for g, w in
               zip(tree_leaves(caches), tree_leaves(w_caches)))
    other = tree_map(torch.clone, params)
    for p in (other, params):
        _, logits, _ = step(p, tokens[:, :1], init, 0)
        assert torch.equal(logits, eager(params, tokens[:, :1], init, 0)[1])
    assert len(step.executables) == 2
    assert {e.pool for e in step.executables.values()} == {exe.pool}
    assert [e.graph.replays for e in step.executables.values()] == [3, 1]


def test_a_mesh_context_raises():
    """Under sharding rules with a mesh the compiled step refuses (the
    eager step serves there) and captures nothing."""
    cfg, params, tokens, _ = _inputs("qwen3_8b", 2)
    step = _StandIn(cfg)
    caches = lm.init_caches(cfg, B, 2, device="cpu")
    with shctx.use_rules(types.SimpleNamespace(mesh="mesh")):
        with pytest.raises(RuntimeError, match="mesh"):
            step(params, tokens[:, :1], caches, 0)
    assert step.executables == {}


# ---------------------------------------------------------------------------
# the CPU path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_cpu_path_is_the_eager_step(arch):
    """On the CPU ``compile_decode_step`` is ``make_decode_step``: 8
    steps' ids, logits and caches bit for bit, nothing cached."""
    cfg, params, tokens, enc = _inputs(arch, 8, seed=3)
    step = compile_decode_step(cfg)
    init = lm.init_caches(cfg, B, 8, device="cpu")
    want, want_caches = _eager_loop(cfg, params, tokens, enc, 8, init)
    caches = init
    for i, (w_nxt, w_logits) in enumerate(want):
        nxt, logits, caches = step(params, tokens[:, i:i + 1], caches, i,
                                   encoder_states=enc)
        assert torch.equal(nxt, w_nxt) and torch.equal(logits, w_logits)
    assert all(torch.equal(g, w) for g, w in
               zip(tree_leaves(caches), tree_leaves(want_caches)))
    assert step.executables == {}
