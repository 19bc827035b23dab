"""The port's training substrate (``repro_torch.data``, ``repro_torch.train``,
``launch.train``) on the CPU against the JAX package's: the token
pipeline, AdamW and its clip, int8 gradient compression, the cross
entropy, checkpoints in both directions, and the launcher's resume and
preemption.

Inputs are numpy draws from a seed; JAX's trees cross with
``convert.tree_from_jax``.
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models import lm as jlm
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train.step import cross_entropy as jax_cross_entropy
from repro_torch.convert import tree_from_jax
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         compress_grads, decompress_grads,
                                         init_opt_state)
from repro_torch.train.step import cross_entropy
from repro_torch.tree import tree_items, tree_leaves

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYP = True
except ImportError:  # pragma: no cover
    HAVE_HYP = False

EPS32 = float(np.finfo(np.float32).eps)


def _np_items(tree) -> dict:
    """JAX tree -> {path: numpy array}, keyed as the checkpoint keys it."""
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_items(tree) -> dict:
    return {k: v.numpy() for k, v in tree_items(tree)}


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq,seed", [(1000, 4, 16, 5),
                                                  (92544, 2, 34, 11),
                                                  (7, 8, 2, 0)])
def test_pipeline_batches_equal_jax(vocab, batch, seq, seed):
    """``batch_at``, iteration, ``from_state`` skip-ahead and
    ``host_slice``: int32 tokens equal to the JAX package's."""
    ref = JaxPipeline(vocab, batch, seq, seed=seed)
    got = TokenPipeline(vocab, batch, seq, seed=seed, device="cpu")
    for step in (0, 1, 3, 1000):
        want = np.asarray(ref.batch_at(step)["tokens"])
        t = got.batch_at(step)["tokens"]
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), want)
    ref_it = [np.asarray(b["tokens"]) for _, b in zip(range(3), ref)]
    got_it = [b["tokens"].numpy() for _, b in zip(range(3), got)]
    np.testing.assert_array_equal(np.stack(got_it), np.stack(ref_it))
    assert got.state() == ref.state() == {"seed": seed, "step": 3}
    resumed = TokenPipeline.from_state(vocab, batch, seq,
                                       {"seed": seed, "step": 2},
                                       device="cpu")
    np.testing.assert_array_equal(next(iter(resumed))["tokens"].numpy(),
                                  ref_it[2])
    hosts = 2 if batch % 2 == 0 else 1
    b_ref, b_got = ref.batch_at(7), got.batch_at(7)
    for h in range(hosts):
        np.testing.assert_array_equal(
            got.host_slice(b_got, h, hosts)["tokens"].numpy(),
            np.asarray(ref.host_slice(b_ref, h, hosts)["tokens"]))


def test_pipeline_without_device_raises_on_a_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenPipeline(1000, 4, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _grad_tree(rng) -> dict:
    """A small tree whose dict order differs from jax.tree's sorted one."""
    return {"z": {"w": rng.standard_normal((64, 32)).astype(np.float32),
                  "b": rng.standard_normal((7,)).astype(np.float32)},
            "a": (rng.standard_normal((3, 5, 9)) * 1e-3).astype(np.float32)}


def _max_rel(got: dict, want: dict) -> float:
    """Largest leaf gap over that leaf's max |value|, in float32 eps."""
    return max(float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30))
               for k, w in want.items()) / EPS32


# AdamW against jitted JAX (how the JAX package trains) on the same
# params, gradients and state at every step: XLA contracts the moment
# updates into FMAs and sums the norm in its own order, so leaves differ
# by a few ulps (measured <= 5.3 eps of the leaf's max |value| over 30
# steps of these configs, grad_norm <= 4 ulps); lr is bit for bit.
ADAM_TOL_EPS = 8


@pytest.mark.parametrize("cfg", [
    dict(), dict(lr=1e-2, warmup_steps=5, clip_norm=0.5),
    dict(warmup_steps=3, weight_decay=0.0, clip_norm=1e9)], ids=str)
def test_adamw_update_matches_jitted_jax(cfg):
    rng = np.random.default_rng(0)
    jcfg, pcfg = jopt.OptimizerConfig(**cfg), OptimizerConfig(**cfg)
    params = _grad_tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp)
    upd = jax.jit(lambda p, g, s: jopt.adamw_update(jcfg, p, g, s))
    for _ in range(30):
        grads = _grad_tree(rng)
        tp, ts = tree_from_jax(_np_items_tree(jp)), tree_from_jax(
            _np_items_tree(js))
        got_p, got_s, got_m = adamw_update(pcfg, tp, tree_from_jax(grads),
                                           ts)
        jp, js, jm = upd(jp, jax.tree.map(jnp.asarray, grads), js)
        assert _max_rel(_torch_items(got_p), _np_items(jp)) <= ADAM_TOL_EPS
        for part in ("m", "v"):
            assert _max_rel(_torch_items(got_s[part]),
                            _np_items(js[part])) <= ADAM_TOL_EPS, part
        assert got_s["step"].dtype == torch.int32
        assert int(got_s["step"]) == int(js["step"])
        assert got_m["lr"].item() == float(jm["lr"])
        assert abs(got_m["grad_norm"].item() / float(jm["grad_norm"]) - 1) \
            <= ADAM_TOL_EPS * EPS32


def _np_items_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_init_opt_state_matches_jax():
    jp = jlm.init_params(jax_get_config("internlm2_1_8b").reduced(),
                         jax.random.PRNGKey(0))
    want = _np_items(jopt.init_opt_state(jp))
    got = init_opt_state(tree_from_jax(_np_items_tree(jp)))
    got_items = _torch_items(got)
    assert list(got_items) == list(want)
    for k, w in want.items():
        assert got_items[k].dtype == w.dtype and got_items[k].shape \
            == w.shape and not got_items[k].any(), k
    assert got["step"].shape == () and got["step"].dtype == torch.int32


def test_adamw_moves_toward_gradient():
    params = {"w": torch.ones((4,))}
    grads = {"w": torch.tensor([1.0, -1.0, 2.0, 0.0])}
    state = init_opt_state(params)
    cfg = OptimizerConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    new, state, m = adamw_update(cfg, params, grads, state)
    assert float(new["w"][0]) < 1.0      # positive grad -> decrease
    assert float(new["w"][1]) > 1.0
    assert m["grad_norm"] > 0
    assert torch.equal(params["w"], torch.ones((4,)))   # input left as is
    jnew, _, jm = jopt.adamw_update(
        jopt.OptimizerConfig(lr=0.1, weight_decay=0.0, warmup_steps=1),
        {"w": jnp.ones((4,))}, {"w": jnp.asarray(grads["w"].numpy())},
        jopt.init_opt_state({"w": jnp.ones((4,))}))
    np.testing.assert_array_equal(new["w"].numpy(), np.asarray(jnew["w"]))
    assert m["grad_norm"].item() == float(jm["grad_norm"])


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros((4,))}
    grads = {"w": torch.full((4,), 1e6)}
    state = init_opt_state(params)
    cfg = OptimizerConfig(lr=0.1, clip_norm=1.0, weight_decay=0.0,
                          warmup_steps=1)
    new, _, m = adamw_update(cfg, params, grads, state)
    assert torch.isfinite(new["w"]).all()
    assert float(m["grad_norm"]) > 1e5   # reported pre-clip
    jnew, _, jm = jopt.adamw_update(
        jopt.OptimizerConfig(lr=0.1, clip_norm=1.0, weight_decay=0.0,
                             warmup_steps=1),
        {"w": jnp.zeros((4,))}, {"w": jnp.full((4,), 1e6)},
        jopt.init_opt_state({"w": jnp.zeros((4,))}))
    np.testing.assert_array_equal(new["w"].numpy(), np.asarray(jnew["w"]))
    assert m["grad_norm"].item() == float(jm["grad_norm"])


# ---------------------------------------------------------------------------
# int8 gradient compression: bit for bit against eager JAX
# ---------------------------------------------------------------------------

def _assert_compress_equal(grads: dict):
    want = jopt.compress_grads(jax.tree.map(jnp.asarray, grads))
    got = compress_grads(tree_from_jax(grads))
    for k in grads:
        assert got[k]["q"].dtype == torch.int8
        np.testing.assert_array_equal(got[k]["q"].numpy(),
                                      np.asarray(want[k]["q"]))
        assert got[k]["scale"].shape == () and \
            got[k]["scale"].item() == float(want[k]["scale"])
    rt, jrt = decompress_grads(got), jopt.decompress_grads(want)
    for k in grads:
        np.testing.assert_array_equal(rt[k].numpy(), np.asarray(jrt[k]))


def test_compress_grads_equals_jax():
    rng = np.random.default_rng(4)
    grads = {"a": np.linspace(-3, 3, 1000, dtype=np.float32)
             .reshape(10, 100),
             "b": np.zeros((5,), np.float32),
             "c": (rng.standard_normal((64, 33))
                   * 10.0 ** rng.integers(-8, 4, (64, 1))).astype(np.float32)}
    for scale in 10.0 ** np.arange(-6, 7, 2):
        grads[f"s{scale:g}"] = (rng.standard_normal(4096) * scale) \
            .astype(np.float32)
    _assert_compress_equal(grads)
    rt = decompress_grads(compress_grads(tree_from_jax(grads)))
    err = (rt["a"] - torch.from_numpy(grads["a"])).abs().max().item()
    assert err <= np.abs(grads["a"]).max() / 127.0 + 1e-6
    assert not rt["b"].any()
    nested = decompress_grads(compress_grads({"n": {"c": torch.from_numpy(
        grads["c"])}}))
    assert torch.equal(nested["n"]["c"], rt["c"])


if HAVE_HYP:
    @given(st.lists(st.floats(-1e3, 1e3, allow_nan=False, width=32),
                    min_size=1, max_size=64))
    @settings(max_examples=30, deadline=None)
    def test_property_compression_equals_jax(vals):
        """q and scale bit for bit against JAX's, and |err| <= max|g|/127."""
        g = np.asarray(vals, np.float32)
        _assert_compress_equal({"g": g})
        rt = decompress_grads(compress_grads({"g": torch.from_numpy(g)}))
        bound = float(np.abs(g).max()) / 127.0 + 1e-6
        assert float((rt["g"] - torch.from_numpy(g)).abs().max()) <= bound


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_jax_with_padding_and_negative_labels():
    """Loss and its gradient: the logsumexp over all padded columns, and
    labels < 0 or >= vocab_size masked (clamped before the gather)."""
    rng = np.random.default_rng(7)
    vocab, padded = 500, 512
    logits = (rng.standard_normal((3, 17, padded)) * 4).astype(np.float32)
    labels = rng.integers(-3, padded + 40, (3, 17)).astype(np.int32)
    labels[0, :4] = [-1, 499, 500, 511]
    jl, jg = jax.value_and_grad(jax_cross_entropy)(jnp.asarray(logits),
                                                   jnp.asarray(labels), vocab)
    lt = torch.from_numpy(logits).requires_grad_()
    loss = cross_entropy(lt, torch.from_numpy(labels), vocab)
    loss.backward()
    assert abs(loss.item() / float(jl) - 1) <= 1e-6
    assert np.abs(lt.grad.numpy() - np.asarray(jg)).max() \
        <= 1e-6 * np.abs(np.asarray(jg)).max()
    # a bfloat16 input reduces in float32; all labels masked gives 0
    bf = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                       torch.from_numpy(labels), vocab)
    assert bf.dtype == torch.float32
    assert cross_entropy(lt, torch.full((3, 17), -1), vocab).item() == 0.0


# ---------------------------------------------------------------------------
# checkpoints: the JAX package's layout, both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_state():
    """Reduced InternLM2's parameters and a non-zero optimizer state."""
    cfg = jax_get_config("internlm2_1_8b").reduced()
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    opt = jopt.init_opt_state(params)
    grads = jax.tree.map(lambda p: jnp.cos(p * 7.0), params)
    params, opt, _ = jopt.adamw_update(jopt.OptimizerConfig(), params,
                                       grads, opt)
    return _np_items_tree(params), _np_items_tree(opt)


def _assert_tree_equal(got, want: dict):
    items = _torch_items(got)
    assert items.keys() == want.keys()
    for k, w in want.items():
        assert items[k].dtype == w.dtype, k
        np.testing.assert_array_equal(items[k], w, err_msg=k)


def test_jax_checkpoint_restores_in_the_port(tmp_path, jax_state):
    params, opt = jax_state
    jck.save_checkpoint(tmp_path, 5, params, opt, {"seed": 3, "step": 5})
    like_p = tree_from_jax(params)
    like_o = init_opt_state(like_p)
    got_p, got_o, ds = restore_checkpoint(tmp_path, latest_step(tmp_path),
                                          like_p, like_o)
    assert ds == {"seed": 3, "step": 5}
    _assert_tree_equal(got_p, _np_items(params))
    _assert_tree_equal(got_o, _np_items(opt))
    assert int(got_o["step"]) == 1 and got_o["step"].shape == ()


def test_port_checkpoint_restores_in_jax(tmp_path, jax_state):
    params, opt = jax_state
    tp, to = tree_from_jax(params), tree_from_jax(opt)
    save_checkpoint(tmp_path, 9, tp, to, {"seed": 11, "step": 9})
    with np.load(tmp_path / "step_9" / "params.npz") as f:
        assert "blocks/attn/wq" in f.files
    with np.load(tmp_path / "step_9" / "opt_state.npz") as f:
        assert {"step", "m/blocks/mlp/w_up"} <= set(f.files)
    jp, jo, ds = jck.restore_checkpoint(tmp_path, jck.latest_step(tmp_path),
                                        params, opt)
    assert ds == {"seed": 11, "step": 9}
    for want, got in ((params, jp), (opt, jo)):
        w, g = _np_items(want), _np_items(got)
        assert w.keys() == g.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_checkpoint_roundtrip_atomicity_and_sharding_hook(tmp_path,
                                                          jax_state):
    params = tree_from_jax(jax_state[0])
    opt = tree_from_jax(jax_state[1])
    save_checkpoint(tmp_path, 7, params, opt, {"seed": 3, "step": 7})
    save_checkpoint(tmp_path, 9, params, opt, {"seed": 3, "step": 9})
    assert latest_step(tmp_path) == 9
    # a stale .tmp dir must not be visible as a checkpoint
    (tmp_path / "step_11.tmp").mkdir()
    assert latest_step(tmp_path) == 9
    assert latest_step(tmp_path / "absent") is None
    placed = {}

    def sharding_fn(key, arr):      # stand-in for a new layout's placement
        placed[key] = arr.shape
        return torch.from_numpy(arr)

    p2, o2, ds = restore_checkpoint(tmp_path, 9, params, opt,
                                    sharding_fn=sharding_fn)
    assert ds == {"seed": 3, "step": 9}
    # every leaf of params AND opt state goes through the hook
    assert len(placed) == len(tree_leaves(params)) + len(tree_leaves(opt))
    _assert_tree_equal(p2, _torch_items(params))
    _assert_tree_equal(o2, _torch_items(opt))
    # restored leaves take the dtype of the structure they restore into
    bf = restore_checkpoint(tmp_path, 9, {k: v.to(torch.bfloat16) if k ==
                                          "embed" else v
                                          for k, v in params.items()},
                            opt)[0]
    assert bf["embed"].dtype == torch.bfloat16
    wrong = dict(params, embed=params["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        restore_checkpoint(tmp_path, 9, wrong, opt)


# ---------------------------------------------------------------------------
# the launcher: resume and preemption
# ---------------------------------------------------------------------------

def _run(ckpt, steps, capsys, *extra) -> str:
    launch_train.main(["--arch", "internlm2_1_8b", "--reduced", "--steps",
                       str(steps), "--batch", "4", "--seq", "32",
                       "--ckpt-dir", str(ckpt), "--device", "cpu", *extra])
    return capsys.readouterr().out


def _final(ckpt, step) -> dict:
    out = {}
    for name in ("params", "opt_state"):
        with np.load(ckpt / f"step_{step}" / f"{name}.npz") as f:
            out.update({f"{name}/{k}": f[k] for k in f.files})
    return out


def test_launcher_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """3 steps, then a relaunch to 6 that resumes at 3 and skips the
    pipeline ahead: its final state equals a fresh 6-step run's bit for
    bit.  The first run's --ckpt-every divides --steps, where the JAX
    launcher saves step 3 twice and fails on the second rename."""
    a, b = tmp_path / "a", tmp_path / "b"
    assert "training complete" in _run(a, 3, capsys, "--ckpt-every", "3")
    assert latest_step(a) == 3 and not (a / "step_3.tmp").exists()
    out = _run(a, 6, capsys)
    assert "[resume] step 3" in out and "training complete" in out
    _run(b, 6, capsys)
    got, want = _final(a, 6), _final(b, 6)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(want["opt_state/step"]) == 6


def test_launcher_checkpoints_and_returns_when_preempted(tmp_path, capsys,
                                                         monkeypatch):
    """The flag the SIGTERM handler sets: the loop checkpoints at the next
    step boundary and returns; main restores the previous handler."""
    monkeypatch.setattr(launch_train, "_PREEMPTED", False)
    before = signal.getsignal(signal.SIGTERM)
    launch_train._on_sigterm(signal.SIGTERM, None)
    out = _run(tmp_path, 6, capsys, "--ckpt-every", "100")
    assert "[preempt] checkpointed at 1, exiting cleanly" in out
    assert "training complete" not in out
    assert latest_step(tmp_path) == 1
    assert signal.getsignal(signal.SIGTERM) == before
    with open(tmp_path / "step_1" / "meta.json") as f:
        assert '"step": 1' in f.read()
