"""The port's examples (``examples/*_torch.py``) against the JAX package's
(``examples/*.py``) on the CPU.

Both sides compute on the same weights (carried across with
``convert.params_from_jax`` / ``tree_from_jax``) and the same seeded
inputs.  The examples are scripts, so they are loaded by path.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_config as jax_get_config
from repro.core.crossbar import CrossbarConfig as JCfg
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models import cnn as jcnn
from repro.models import lm as jlm
from repro.serve.step import make_decode_step as jax_make_decode_step
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, tree_from_jax
from repro_torch.tree import tree_items

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart_torch", "crossbar_inference_torch", "serve_lm_torch",
            "train_lm_torch")
# float32 logits against JAX's, relative to max |logit|: the tolerance of
# tests/test_torch_lm.py and tests/test_torch_lm_serve.py
LOGIT_TOL = 1e-4
# bfloat16 compute: the two packages round in different places, so
# logits and training steps are held by correlation and a 2% loss gap
# (tests/test_torch_lm.py, tests/test_torch_train_system.py)
BF16_CORR = 0.99
BF16_LOSS = 2e-2
NOISE_REL = 0.15     # tests/test_torch_functional.py's noise statistic


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        out = fn(*args, **kw)
    return out, buf.getvalue()


# ---------------------------------------------------------------------------
# imports and the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", EXAMPLES)
def test_example_source_imports_neither_jax_nor_repro(name):
    with open(os.path.join(ROOT, "examples", f"{name}.py")) as f:
        src = f.read()
    bad = re.findall(r"^\s*(?:import|from)\s+(?:jax|repro)(?:[.\s]|$).*",
                     src, re.M)
    assert not bad, bad


_PROBE = """
import importlib.util, json, os, sys
out = {}
for name in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(
        name, os.path.join("examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "repro"))
    try:
        mod.main([])
        raised = None
    except RuntimeError as e:
        raised = str(e)
    out[name] = dict(leaked=leaked, raised=raised)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe():
    """Each example loaded in a fresh process without a visible GPU:
    the modules it pulled in, and what ``main([])`` (the default device,
    the GPU) raised."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-c", _PROBE, *EXAMPLES], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_loads_without_jax_or_repro(probe, name):
    assert probe[name]["leaked"] == []


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_gpu_by_default(probe, name):
    """No fallback: asked for the card (the default) on a host without
    one, each example raises before it computes anything."""
    assert probe[name]["raised"] and "device='cpu'" in probe[name]["raised"]


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["custom", "alexnet", "vit-tiny"])
def test_quickstart_is_bit_exact_on_the_cpu(net):
    quick = _load("quickstart_torch")
    r, text = _quiet(quick.main, ["--net", net, "--batch", "2", "--device",
                                  "cpu"])
    assert text.splitlines()[0] == "device: cpu"
    assert r["exact"] and r["roundtrip"] and r["agree"] == 1.0
    assert r["launches"] == {"crossbar_gemm": 0, "fb_epilogue": 0}
    assert text.count("bit-exact=True") == 2
    assert ("sim" in r) == (net != "vit-tiny")


def test_quickstart_sim_table_equals_the_jax_example():
    """``simulate`` is host only and deterministic: the port's table is the
    JAX example's ``print_sim_table`` output, line for line."""
    quick, jquick = _load("quickstart_torch"), _load("quickstart")
    cfg = dict(array_rows=511)
    from repro_torch import api as tapi
    tm = tapi.compile("alexnet", tapi.HurryConfig(**cfg), device="cpu")
    jm = japi.compile("alexnet", japi.HurryConfig(**cfg))
    _, want = _quiet(jquick.print_sim_table, jm)
    assert quick.sim_table(tm).splitlines() == want.rstrip("\n").splitlines()


# ---------------------------------------------------------------------------
# crossbar_inference
# ---------------------------------------------------------------------------

def test_crossbar_inference_against_the_jax_example():
    """AlexNet at batch 2 on JAX's ``init(PRNGKey(1))``: float32 logits to
    1e-4, the clean crossbar (512 rows / 9-bit ADC, conv1 on the exact
    branch, the rest sliced) bit-exact, the noisy run's relative error
    within 15% of JAX's (the draws cannot match across the two random
    generators); no kernel launch on the CPU."""
    xb = _load("crossbar_inference_torch")
    net = "alexnet"
    m = jcnn.CNN_MODELS[net]
    params = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(1)))
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jp, jx = jax.tree.map(jnp.asarray, params), jnp.asarray(x)

    def fwd(cfg=None):
        mm = (jcnn.fp_matmul if cfg is None else jcnn.make_crossbar_matmul(
            cfg, noise_key=jax.random.PRNGKey(9)))
        return np.asarray(jax.jit(lambda p, v: m.forward(p, v, mm=mm))(jp,
                                                                       jx))

    y_fp = fwd()
    want = {"clean": fwd(JCfg()), "noisy": fwd(JCfg(noise_sigma_thermal=0.3))}
    before = trace.counters().get("launches.crossbar_gemm", 0)
    got = xb.evaluate(net, params_from_jax(params), torch.from_numpy(x))
    assert trace.counters().get("launches.crossbar_gemm", 0) == before
    np.testing.assert_allclose(got["fp32"]["logits"].numpy(), y_fp, rtol=1e-4,
                               atol=1e-4 * np.abs(y_fp).max())
    np.testing.assert_array_equal(got["clean"]["logits"].numpy(),
                                  want["clean"])
    assert got["clean"]["branches"] == {"exact branch": 1,
                                        "sliced branch": 7}
    assert got["noisy"]["branches"] == {"plain sliced model": 8}
    assert got["clean"]["launches"] == got["noisy"]["launches"] == 0
    ref = np.linalg.norm(want["noisy"] - y_fp) / np.linalg.norm(y_fp)
    assert abs(got["noisy"]["rel"] - ref) <= NOISE_REL * ref, (
        got["noisy"]["rel"], ref)


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------

B, PROMPT, NEW = 4, 16, 32      # the example's defaults


def _serve_inputs(arch):
    cfg = jax_get_config(arch).reduced()
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    prompts = jax.random.randint(jax.random.PRNGKey(1), (B, PROMPT), 0,
                                 cfg.vocab_size)
    enc = None
    if cfg.is_encdec:
        enc = jax.random.normal(jax.random.PRNGKey(2),
                                (B, cfg.encoder_seq, cfg.d_model)
                                ).astype(jnp.bfloat16)
    return cfg, params, prompts, enc


def _jax_loop(cfg, params, prompts, enc, decode, caches):
    """The JAX example's loop: prefill token by token, then greedy decode;
    every step's last-position logits as float32."""
    tok, logits, out = prompts[:, :1], [], [prompts]
    for i in range(PROMPT + NEW - 1):
        nxt, lg, caches = decode(params, tok, caches, jnp.array(i), enc)
        logits.append(np.asarray(lg[:, -1], np.float32))
        if i < PROMPT - 1:
            tok = prompts[:, i + 1:i + 2]
        else:
            tok = nxt
            out.append(tok)
    return np.asarray(jnp.concatenate(out, 1)), np.stack(logits, 1)


def _port_loop(arch, params, prompts, enc, dtype):
    sv = _load("serve_lm_torch")
    return sv.generate(get_config(arch).reduced(),
                       tree_from_jax(jax.tree.map(np.asarray, params)),
                       torch.from_numpy(np.array(prompts)),
                       None if enc is None else tree_from_jax(np.asarray(enc)),
                       NEW, compute_dtype=dtype)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "xlstm_1_3b",
                                  "whisper_medium"])
def test_serve_lm_loop_float32_against_jax(arch):
    """The example's loop in float32 compute (float32 caches) against the
    JAX example's loop over a jitted float32 decode step: every step's
    logits within 1e-4 of max |logit|, the continuation ids equal."""
    cfg, params, prompts, enc = _serve_inputs(arch)

    @jax.jit
    def decode(p, tok, caches, i, e):
        lg, caches = jlm.decode_step(p, cfg, tok, caches, i,
                                     encoder_states=e,
                                     compute_dtype=jnp.float32)
        return (jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None], lg,
                caches)

    seqs, logits = _jax_loop(
        cfg, params, prompts, enc, decode,
        jlm.init_caches(cfg, B, PROMPT + NEW, dtype=jnp.float32))
    got = _port_loop(arch, params, prompts, enc, torch.float32)
    gap = np.abs(got["logits"].numpy() - logits).max() / np.abs(logits).max()
    assert gap <= LOGIT_TOL, gap
    np.testing.assert_array_equal(got["seqs"].numpy(), seqs)


def test_serve_lm_example_bfloat16_against_jax():
    """The examples as they run, bfloat16 compute, over JAX's jitted
    ``serve.step.make_decode_step``: until the first step whose ids
    differ (a near tie under the packages' different bfloat16 roundings),
    the logits correlate at 0.99."""
    arch = "internlm2_1_8b"
    cfg, params, prompts, enc = _serve_inputs(arch)
    step = jax.jit(jax_make_decode_step(cfg))
    seqs, logits = _jax_loop(
        cfg, params, prompts, enc,
        lambda p, t, c, i, e: step(p, t, c, i, encoder_states=e),
        jlm.init_caches(cfg, B, PROMPT + NEW))
    got = _port_loop(arch, params, prompts, enc, torch.bfloat16)
    same = (got["seqs"].numpy() == seqs).all(0)
    n = PROMPT + (int(np.argmin(same[PROMPT:])) if not same.all()
                  else NEW) - 1
    a, b = got["logits"].numpy()[:, :n + 1], logits[:, :n + 1]
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    print(f"{arch} bf16: ids equal for {n - PROMPT + 1} of {NEW} decode "
          f"steps, logit correlation {corr:.5f}")
    assert corr >= BF16_CORR, corr


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

def _small_config(get):
    return dataclasses.replace(get("internlm2_1_8b").reduced(), n_layers=2)


def _np_items(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_train_lm_loop_against_the_jax_example(tmp_path):
    """4 steps at b2 x 32 from JAX's ``init_params(PRNGKey(0))`` and the
    same ``TokenPipeline(seed=17)``: bfloat16 compute, so each step's
    loss within 2% of the JAX example's loop and the parameter updates
    correlated at 0.99."""
    tl = _load("train_lm_torch")
    cfg = _small_config(jax_get_config)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    # the JAX example's loop
    opt = jopt.init_opt_state(params)
    pipe = JaxPipeline(cfg.vocab_size, 2, 32, seed=17)
    step_fn = jax.jit(jstep.make_train_step(
        cfg, jopt.OptimizerConfig(lr=1e-3), remat=False))
    jp, losses = params, []
    for i in range(4):
        batch = pipe.batch_at(i)
        pipe.step = i + 1
        jp, opt, metrics = step_fn(jp, opt, batch)
        losses.append(float(metrics["loss"]))

    r, _ = _quiet(tl.train, _small_config(get_config),
                  tree_from_jax(jax.tree.map(np.asarray, params)), steps=4,
                  batch=2, seq=32, ckpt_dir=str(tmp_path), ckpt_every=50)
    assert r["start"] == 0 and len(r["losses"]) == 4
    np.testing.assert_allclose(r["losses"], losses, rtol=BF16_LOSS)
    p0, want = _np_items(params), _np_items(jp)
    got = {k: v.numpy() for k, v in tree_items(r["params"])}
    assert got.keys() == want.keys()
    du = np.concatenate([(got[k] - p0[k]).ravel() for k in want])
    dw = np.concatenate([(want[k] - p0[k]).ravel() for k in want])
    corr = np.corrcoef(du, dw)[0, 1]
    assert corr >= BF16_CORR, corr


@pytest.fixture
def small_train(monkeypatch):
    """``examples/train_lm_torch.py`` with ``build_100m_config`` patched
    to a 2-layer reduced InternLM2."""
    tl = _load("train_lm_torch")
    monkeypatch.setattr(tl, "build_100m_config",
                        lambda: _small_config(get_config))
    return tl


def test_train_lm_resume_equals_a_fresh_run(tmp_path, small_train):
    """To 2 steps, then to 4 in the same directory (it resumes from 2),
    equals a fresh 4-step run bit for bit; each step is saved once."""
    args = ["--batch", "2", "--seq", "32", "--ckpt-every", "2", "--device",
            "cpu"]
    _quiet(small_train.main, ["--steps", "2", "--ckpt-dir",
                              str(tmp_path / "a"), *args])
    r, text = _quiet(small_train.main, ["--steps", "4", "--ckpt-dir",
                                        str(tmp_path / "a"), *args])
    assert "resumed from step 2" in text and r["start"] == 2
    fresh, _ = _quiet(small_train.main, ["--steps", "4", "--ckpt-dir",
                                         str(tmp_path / "b"), *args])
    assert sorted(os.listdir(tmp_path / "a")) == ["step_2", "step_4"]
    for (k, a), (_, b) in zip(tree_items(r["params"]),
                              tree_items(fresh["params"])):
        assert torch.equal(a, b), k
    for (k, a), (_, b) in zip(tree_items(r["opt"]), tree_items(fresh["opt"])):
        assert torch.equal(a, b), k


def test_train_lm_checkpoint_restores_in_jax(tmp_path, small_train):
    """The port's checkpoint (the JAX package's format) restores in
    ``repro.train.checkpoint.restore_checkpoint``, leaf for leaf."""
    r, _ = _quiet(small_train.main, ["--steps", "2", "--batch", "2", "--seq",
                                     "32", "--ckpt-dir", str(tmp_path),
                                     "--device", "cpu"])
    cfg = _small_config(jax_get_config)
    like = jlm.init_params(cfg, jax.random.PRNGKey(0))
    params, opt, data = jck.restore_checkpoint(
        str(tmp_path), jck.latest_step(str(tmp_path)), like,
        jopt.init_opt_state(like))
    assert data == {"seed": 17, "step": 2}
    got = _np_items(params)
    for k, v in tree_items(r["params"]):
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    assert int(opt["step"]) == int(r["opt"]["step"]) == 2
