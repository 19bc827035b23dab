"""The compiled LM train step (``train.step.compile_train_step``) on the
CPU.

On a CUDA device the step is captured once per key as a CUDA graph that
updates its own parameters and optimizer state in place, and replayed
(``TrainExecutable``), as the JAX training entry points call
``jax.jit(make_train_step(...))``.  What can be held here: the step and
its in-place twin make no host sync, no tensor sized by the data and no
CPU tensor for any arch, with remat on and off (a dispatch mode over a
step on the ``meta`` device); the in-place optimizer equals
``adamw_update`` bit for bit; the key; a replay's bookkeeping over a
stand-in graph that runs the in-place step on the executable's static
buffers, as a replay does (state copied in only when foreign, fresh
metrics, one executable per key, a mesh refused); and that the CPU path
is the eager step with nothing cached.  The capture itself runs on the
card (``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phases 22 and
24).
"""

import dataclasses
import types

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import lm
from repro_torch.sharding import context as shctx
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         adamw_update_, init_opt_state)
from repro_torch.train.step import (CompiledTrainStep, compile_train_step,
                                    make_inplace_train_step,
                                    make_train_step, train_key)
from repro_torch.tree import tree_items, tree_leaves, tree_map

from torch_capture import CaptureSafety

B, S = 2, 16
OPT = OptimizerConfig(lr=1e-2, warmup_steps=2)


def _inputs(arch: str, seed: int = 0, batch: int = B, **replace):
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    gen = torch.Generator().manual_seed(seed)
    params = lm.init_params(cfg, gen, device="cpu")
    return cfg, params, _batch(cfg, gen, batch)


def _batch(cfg, gen, batch: int = B, seq: int = S) -> dict:
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=gen, dtype=torch.int32)}
    if cfg.is_encdec:
        out["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                    generator=gen)
    return out


def _equal_trees(got, want) -> None:
    g, w = tree_items(got), tree_items(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), p


# ---------------------------------------------------------------------------
# capture safety: every arch's step on the meta device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inplace", [False, True], ids=["eager", "inplace"])
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_is_capture_safe(arch, remat, inplace):
    """``make_train_step`` and ``make_inplace_train_step`` on ``meta``
    tensors under ``CaptureSafety`` (b2 x 16, backward and AdamW
    included): every op can be captured, and the metrics are 0-d."""
    cfg, params, batch = _inputs(arch)
    params = tree_map(lambda t: t.to("meta"), params)
    batch = tree_map(lambda t: t.to("meta"), batch)
    opt = init_opt_state(params)
    make = make_inplace_train_step if inplace else make_train_step
    step = make(cfg, OPT, remat=remat)
    mode = CaptureSafety()
    with mode:
        out = step(params, opt, batch)
    metrics = out if inplace else out[2]
    assert mode.ops > 1000
    assert sorted(metrics) == ["grad_norm", "loss", "lr"]
    assert all(m.shape == () for m in metrics.values())
    if not inplace:
        assert [(p, t.shape, t.dtype) for p, t in tree_items(out[0])] == \
            [(p, t.shape, t.dtype) for p, t in tree_items(params)]


# ---------------------------------------------------------------------------
# the in-place optimizer
# ---------------------------------------------------------------------------

def _grads(params, gen, scale: float):
    return tree_map(lambda p: (torch.randn(p.shape, generator=gen) * scale)
                    .to(p.dtype), params)


@pytest.mark.parametrize("bf16_leaf", [False, True],
                         ids=["float32", "bf16-leaf"])
def test_inplace_adamw_equals_adamw_update(bf16_leaf):
    """Three steps of ``adamw_update_`` against ``adamw_update`` on the
    same gradients: parameters, ``m``, ``v``, ``step`` and the metrics
    ``torch.equal`` after each; the second step's global norm is far over
    ``clip_norm`` (its gradients clipped), the others under it.  The
    in-place step writes into the tensors it was given."""
    gen = torch.Generator().manual_seed(4)
    params = {"a": torch.randn((5, 7), generator=gen),
              "blocks": {"w": torch.randn((3, 4, 6), generator=gen),
                         "b": torch.randn((6,), generator=gen)}}
    if bf16_leaf:
        params["blocks"]["w"] = params["blocks"]["w"].to(torch.bfloat16)
    state = init_opt_state(params)
    own_p = tree_map(torch.clone, params)
    own_s = tree_map(torch.clone, state)
    leaves = tree_leaves(own_p) + tree_leaves(own_s)
    norms = []
    for scale in (1e-3, 10.0, 1e-2):
        grads = _grads(params, gen, scale)
        params, state, want = adamw_update(OPT, params, grads, state)
        got = adamw_update_(OPT, own_p, grads, own_s)
        _equal_trees(own_p, params)
        _equal_trees(own_s, state)
        _equal_trees(got, want)
        norms.append(float(want["grad_norm"]))
    assert norms[0] < OPT.clip_norm < norms[1] and norms[2] < OPT.clip_norm
    assert all(a is b for a, b in zip(leaves, tree_leaves(own_p)
                                      + tree_leaves(own_s)))
    assert int(own_s["step"]) == 3


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3_8b", "mixtral_8x22b",
                                  "whisper_medium"])
def test_inplace_step_equals_make_train_step(arch, microbatches):
    """Two steps of ``make_inplace_train_step`` on one tree equal two of
    ``make_train_step`` bit for bit: parameters, optimizer state and
    metrics."""
    cfg, params, batch = _inputs(arch, seed=5, batch=4)
    opt = init_opt_state(params)
    own_p, own_o = tree_map(torch.clone, params), tree_map(torch.clone, opt)
    eager = make_train_step(cfg, OPT, microbatches, remat=False)
    inplace = make_inplace_train_step(cfg, OPT, microbatches, remat=False)
    for _ in range(2):
        params, opt, want = eager(params, opt, batch)
        got = inplace(own_p, own_o, batch)
        _equal_trees(got, want)
    _equal_trees(own_p, params)
    _equal_trees(own_o, opt)


# ---------------------------------------------------------------------------
# the key
# ---------------------------------------------------------------------------

def test_train_key_fields():
    """Each leaf's (path, shape, dtype) of the batch, the parameters and
    the optimizer state; no address, so clones share the key."""
    cfg, params, batch = _inputs("whisper_medium")
    opt = init_opt_state(params)
    key = train_key(params, opt, batch)
    assert key == tuple(tuple((p, tuple(t.shape), t.dtype)
                              for p, t in tree_items(tree))
                        for tree in (batch, params, opt))
    assert [p for p, *_ in key[0]] == ["frames", "tokens"]
    assert ("step", (), torch.int32) in key[2]
    assert train_key(*(tree_map(torch.clone, t)
                       for t in (params, opt, batch))) == key
    bf = tree_map(lambda t: t.to(torch.bfloat16), params)
    others = [
        train_key(params, opt, _batch(cfg, torch.Generator(), 1)),
        train_key(params, opt, _batch(cfg, torch.Generator(), B, S + 1)),
        train_key(params, opt, {"tokens": batch["tokens"]}),
        train_key(bf, init_opt_state(bf), batch),
    ]
    assert len({key, *others}) == len(others) + 1


# ---------------------------------------------------------------------------
# a replay's bookkeeping over a stand-in graph
# ---------------------------------------------------------------------------

class _EagerGraph:
    """Stands in for a captured graph: a replay runs the in-place step on
    the executable's static buffers and writes its static metrics, as the
    captured graph does."""

    def __init__(self, step_, exe):
        self.step_, self.exe, self.replays = step_, exe, 0

    def replay(self):
        e = self.exe
        for k, v in self.step_(e.params, e.opt_state, e.batch).items():
            e.metrics[k].copy_(v)
        self.replays += 1


class _StandIn(CompiledTrainStep):
    """``CompiledTrainStep`` taking its CUDA path on the CPU: the capture
    copies the batch and makes the static metrics, as
    ``TrainExecutable.capture`` does, over an ``_EagerGraph``; the pool
    is a stand-in handle."""

    def _captures(self, device):
        return True

    def _pool(self):
        return (len(self.executables), 0)

    def _capture(self, exe, batch):
        exe.batch = tree_map(torch.clone, batch)
        exe.metrics = {k: torch.empty(()) for k in ("grad_norm", "loss",
                                                     "lr")}
        exe.graph = _EagerGraph(self.step_, exe)


def _eager_run(cfg, params, batches, microbatches=1):
    """The eager step over ``batches``: each step's metrics, the last
    params and optimizer state."""
    step = make_train_step(cfg, OPT, microbatches, remat=False)
    opt, outs = init_opt_state(params), []
    for b in batches:
        params, opt, m = step(params, opt, b)
        outs.append(m)
    return outs, params, opt


# (arch, microbatches): a dense, an MoE and the encoder-decoder arch, and
# two microbatches unrolled into the step
REPLAY_CASES = {"qwen3_8b": ("qwen3_8b", 1),
                "mixtral_8x22b": ("mixtral_8x22b", 1),
                "whisper_medium": ("whisper_medium", 1),
                "qwen3_8b microbatches 2": ("qwen3_8b", 2)}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_replays_equal_the_eager_step(case):
    """Three steps through the compiled step over the stand-in graph: one
    executable, whose first call is the eager step (its new trees the
    executable's state, nothing captured), the second captures and both
    later calls replay; every step's metrics and the last state bit for
    bit the eager step's; each step's metrics their own tensors (kept
    ones do not move); the trees returned are the executable's own,
    passed back without a copy and overwritten by the next call, while
    the trees first given are left as they were."""
    arch, micro = REPLAY_CASES[case]
    cfg, params, _ = _inputs(arch, seed=1)
    gen = torch.Generator().manual_seed(7)
    batches = [_batch(cfg, gen, 4) for _ in range(3)]
    want, want_p, want_o = _eager_run(cfg, params, batches, micro)
    kept = tree_map(torch.clone, params)
    step = _StandIn(cfg, OPT, micro, remat=False)
    p, o = params, init_opt_state(params)
    got, returned = [], []
    for b in batches:
        exe = next(iter(step.executables.values()), None)
        versions = None if exe is None else [
            t._version for t in tree_leaves(exe.params)]
        p, o, m = step(p, o, b)
        exe = next(iter(step.executables.values()))
        assert p is exe.params and o is exe.opt_state
        if versions is None:           # the eager step, nothing captured
            assert exe.graph is None and exe.batch is None
        else:                          # the step's own write, no copy-in
            assert all(m[k].data_ptr() != exe.metrics[k].data_ptr()
                       for k in m)
            assert [t._version for t in tree_leaves(p)] == \
                [v + 1 for v in versions]
        got.append(m)
        returned.append(p)
    assert len(step.executables) == 1 and exe.graph.replays == 2
    assert returned[0] is returned[-1]           # overwritten in place
    for g, w in zip(got, want):
        _equal_trees(g, w)
    _equal_trees(p, want_p)
    _equal_trees(o, want_o)
    _equal_trees(params, kept)


def test_foreign_state_is_copied_in_and_a_batch_shape_gets_a_key():
    """A params and optimizer-state tree that is not the executable's own
    (a restored checkpoint, the eager step's) is copied in without a new
    key: the replay continues from it, equal to the eager step.  Another
    batch shape gets an executable of its own, in the first one's pool,
    whose first call is the eager step."""
    cfg, params, _ = _inputs("internlm2_1_8b", seed=2)
    gen = torch.Generator().manual_seed(8)
    batches = [_batch(cfg, gen) for _ in range(3)]
    step = _StandIn(cfg, OPT, remat=False)
    eager = make_train_step(cfg, OPT, remat=False)
    step(params, init_opt_state(params), batches[0])
    (exe,) = step.executables.values()
    # two eager steps from the start: a foreign state at step 2
    p, o, _ = eager(params, init_opt_state(params), batches[0])
    p, o, _ = eager(p, o, batches[1])
    versions = [t._version for t in tree_leaves(exe.params)]
    got_p, got_o, got_m = step(p, o, batches[2])
    assert got_p is exe.params
    assert [t._version for t in tree_leaves(got_p)] == \
        [v + 2 for v in versions]
    want_p, want_o, want_m = eager(p, o, batches[2])
    _equal_trees(got_p, want_p)
    _equal_trees(got_o, want_o)
    _equal_trees(got_m, want_m)
    assert int(got_o["step"]) == 3 and len(step.executables) == 1
    wide = _batch(cfg, gen, B, 2 * S)
    _, _, m = step(want_p, want_o, wide)
    _equal_trees(m, eager(want_p, want_o, wide)[2])
    assert len(step.executables) == 2
    assert {e.pool for e in step.executables.values()} == {exe.pool}
    assert exe.graph.replays == 1
    assert [e.graph for e in step.executables.values()][1:] == [None]


def test_a_mesh_context_raises():
    """Under sharding rules with a mesh the compiled step refuses (the
    eager step trains there) and captures nothing."""
    cfg, params, batch = _inputs("qwen3_8b")
    step = _StandIn(cfg, OPT)
    with shctx.use_rules(types.SimpleNamespace(mesh="mesh")):
        with pytest.raises(RuntimeError, match="mesh"):
            step(params, init_opt_state(params), batch)
    assert step.executables == {}


# ---------------------------------------------------------------------------
# the CPU path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2_1_8b", "granite_moe_3b_a800m",
                                  "zamba2_2_7b", "xlstm_1_3b",
                                  "whisper_medium"])
def test_cpu_path_is_the_eager_step(arch):
    """On the CPU ``compile_train_step`` is ``make_train_step``: 3 steps'
    metrics and the final state bit for bit, nothing cached, the trees
    given left as they were."""
    cfg, params, _ = _inputs(arch, seed=3)
    gen = torch.Generator().manual_seed(9)
    batches = [_batch(cfg, gen) for _ in range(3)]
    want, want_p, want_o = _eager_run(cfg, params, batches)
    kept = tree_map(torch.clone, params)
    step = compile_train_step(cfg, OPT, remat=False)
    p, o = params, init_opt_state(params)
    for b, w in zip(batches, want):
        p, o, m = step(p, o, b)
        _equal_trees(m, w)
    _equal_trees(p, want_p)
    _equal_trees(o, want_o)
    _equal_trees(params, kept)
    assert step.executables == {}
