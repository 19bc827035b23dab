"""The port's program stack (pack, execute, serve, api) against JAX's.

Both sides compute on the same weights (``convert.params_from_jax``) and
the same seeded numpy inputs.  The int8 mount planes must be equal; each
stage must be bit-exact when fed the reference's own input buffer; whole
networks are bit-exact where the chain before the last quantization is
only ReLU / max pool / residual, and within a stated tolerance where an
average pool or a softmax (whose sums XLA orders differently) comes
first.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.program.execute import _static_stage as jax_static_stage
from repro.program.pack import pack_program as jax_pack_program
from repro_torch import api as tapi
from repro_torch.convert import params_from_jax
from repro_torch.kernels import crossbar_gemm, fb_epilogue
from repro_torch.program.execute import _static_stage, execute_packed
from repro_torch.program.pack import pack_program
from repro_torch.program.serve import bucket_batch, pad_batch

# a relative logit tolerance for nets whose last quantized input passed
# through an average pool: a 1-ulp difference in a window sum can move
# one int8 value of the next stage by one step
AVGPOOL_REL = 2e-2


def _custom(builder_mod, name="custom8"):
    """conv, relu, 1x1 projection, residual, max pool, avg pool, fc,
    softmax: every CNN FB mode in one small net."""
    nb = builder_mod.NetworkBuilder(name, input_hw=8, input_ch=4)
    nb.conv(16, name="c1")
    r1 = nb.relu(name="r1")
    proj = nb.conv(24, k=1, padding=0, name="proj", input_from=r1)
    nb.conv(24, name="c2", input_from=r1)
    nb.residual(proj, name="res")
    nb.relu(name="r2")
    nb.maxpool(name="p1")
    nb.conv(32, name="c3")
    nb.relu(name="r3")
    nb.avgpool(k=4, stride=4, name="gap")
    nb.fc(10, name="fc")
    nb.softmax(name="sm")
    return nb.build()


def _graphs(net):
    if net == "custom8":
        return _custom(japi), _custom(tapi)
    return japi.GRAPHS[net](), tapi.GRAPHS[net]()


def _params(jgraph, seed=1):
    """The reference's He init with random biases (the epilogue's bias
    add must be exercised), as numpy."""
    params = jax.tree.map(np.asarray, jgraph.init_params(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return {k: {n: (0.1 * rng.standard_normal(v.shape).astype(np.float32)
                    if n == "b" else v) for n, v in p.items()}
            for k, p in params.items()}


def _models(net, cfg_kw, seed=1):
    jgraph, tgraph = _graphs(net)
    params = _params(jgraph, seed)
    jm = japi.compile(jgraph, japi.HurryConfig(**cfg_kw),
                      params=jax.tree.map(jnp.asarray, params))
    tm = tapi.compile(tgraph, tapi.HurryConfig(**cfg_kw),
                      params=params_from_jax(params), device="cpu")
    return jm, tm, params


def _x(graph, batch, seed=0):
    return np.random.default_rng(seed).standard_normal(
        graph.input_shape(batch)).astype(np.float32)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["custom8", "alexnet"])
def test_pack_program_planes_equal_jax(net):
    jgraph, tgraph = _graphs(net)
    params = _params(jgraph)
    cfg = japi.HurryConfig()
    jp = jax_pack_program(japi.compile(jgraph, cfg).program,
                          jax.tree.map(jnp.asarray, params))
    tprog = tapi.compile(tgraph, tapi.HurryConfig(), params=params,
                         device="cpu").program
    tp = pack_program(tprog, params_from_jax(params))
    assert tp.program.plans == ()
    assert len(tp.stages) == len(jp.stages)
    for a, b in zip(jp.stages, tp.stages):
        assert b.w8.dtype == torch.int8
        np.testing.assert_array_equal(b.w8.numpy(), np.asarray(a.w8))
        assert b.w_amax.numpy() == np.float32(a.w_amax)
        np.testing.assert_array_equal(b.bias.numpy(), np.asarray(a.bias))


# ---------------------------------------------------------------------------
# stage by stage, each fed the reference's own input buffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_kw", [dict(), dict(adc_bits=5)])
def test_static_stage_bit_exact_with_teacher_forcing(cfg_kw):
    """adc_bits=5 puts every stage with more than 31 rows on the sliced
    branch."""
    jm, tm, _ = _models("custom8", cfg_kw)
    jprog, tprog = jm.packed.program, tm.packed.program
    cfg = jprog.cfg
    bufs = {"input": jnp.asarray(_x(jm.graph, 3))}
    stages = jprog.stages()
    for si, ((gemm, posts), jst, tst, (tg, tposts)) in enumerate(zip(
            stages, jm.packed.stages, tm.packed.stages, tprog.stages())):
        assert dataclasses.astuple(tg) == dataclasses.astuple(gemm)
        last = si == len(stages) - 1
        tbufs = {k: torch.from_numpy(np.array(v)) for k, v in bufs.items()}
        for drop in ([False, True] if last else [False]):
            run = jax.jit(lambda st, b, drop=drop: jax_static_stage(
                gemm, posts, st, b, cfg, block_m=512, block_n=512,
                interpret=True, drop_softmax=drop)[1])
            ref = np.asarray(run(jst, bufs))
            dst, got = _static_stage(gemm, posts, tst, tbufs, tprog.cfg,
                                     drop_softmax=drop)
            got = got.numpy()
            assert got.shape == ref.shape
            if last and not drop:        # softmax FB: XLA's exp and sum
                np.testing.assert_allclose(got, ref, rtol=0, atol=2e-7)
            elif any(p.kind == "avgpool" for p in posts):
                # XLA sums a 4x4 window in another order: 1 ulp
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(got, ref, err_msg=gemm.name)
        bufs[dst] = jnp.asarray(ref)


# ---------------------------------------------------------------------------
# whole networks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net,cfg_kw,exact", [
    ("alexnet", dict(array_rows=511), True),     # relu/maxpool chains
    ("alexnet", dict(adc_bits=8), True),         # sliced branch
    ("custom8", dict(), False),                  # avg pool before fc
    ("resnet18", dict(), False),                 # avg pool before fc
])
def test_end_to_end_logits_against_jax(net, cfg_kw, exact):
    jm, tm, _ = _models(net, cfg_kw)
    x = _x(jm.graph, 2)
    ref = np.asarray(jm.run(jnp.asarray(x), logits=True))
    got = tm.run(x, logits=True).numpy()
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        assert (got.argmax(1) == ref.argmax(1)).all()
        assert np.abs(got - ref).max() <= AVGPOOL_REL * np.abs(ref).max()
    if net != "resnet18":        # one more JAX compile; the FB is the same
        probs = tm.run(x).numpy()
        np.testing.assert_allclose(probs, np.asarray(jm.run(jnp.asarray(x))),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-6)


def test_adc8_alexnet_runs_its_stages_on_the_sliced_branch(monkeypatch):
    """486/494-row mounts under an 8-bit ADC can clip, so every stage but
    conv1 (27 rows) takes the sliced branch."""
    cg = importlib.import_module("repro_torch.kernels.crossbar_gemm")
    calls = []
    sliced = cg.crossbar_gemm_ref

    def spy(x, w, **kw):
        calls.append(kw["rows"])
        return sliced(x, w, **kw)

    monkeypatch.setattr(cg, "crossbar_gemm_ref", spy)
    model = tapi.compile("alexnet", tapi.HurryConfig(adc_bits=8),
                         device="cpu")
    model.run(_x(model.graph, 1), logits=True)
    assert len(calls) == len(model.program.stages()) - 1
    assert all(cg.clip_possible(r, 8) for r in calls)


@pytest.mark.parametrize("batch", [3, 5])
def test_odd_batches_equal_the_unbucketed_run(batch):
    _, tm, params = _models("custom8", dict())
    exact = tapi.compile(tm.graph, tm.config, params=params_from_jax(params),
                         buckets=(), device="cpu")
    x = _x(tm.graph, batch, seed=batch)
    assert bucket_batch(batch, tm.buckets) > batch
    got, ref = tm.run(x, logits=True), exact.run(x, logits=True)
    assert got.shape == (batch, 10)
    assert torch.equal(got, ref)


def test_pad_batch_replicates_the_last_request():
    x = torch.arange(12.0).reshape(3, 4)
    p = pad_batch(x, 8)
    assert p.shape == (8, 4) and torch.equal(p[3:], x[-1:].expand(5, 4))
    assert pad_batch(x, 3) is x
    assert bucket_batch(3, (1, 2, 4, 8)) == 4
    assert bucket_batch(300, (1, 2, 4)) == 300


def test_cpu_run_launches_no_kernel_and_buffers_are_dropped():
    _, tm, _ = _models("custom8", dict())
    before = crossbar_gemm.launches, fb_epilogue.launches
    out = execute_packed(tm.packed, torch.from_numpy(_x(tm.graph, 2)))
    assert out.shape == (2, 10)
    assert (crossbar_gemm.launches, fb_epilogue.launches) == before


def test_attention_stages_raise_naming_the_next_slice():
    model = tapi.compile("vit_tiny", device="cpu")
    with pytest.raises(NotImplementedError, match="next slice"):
        model.run(np.zeros(model.program.input_shape(1), np.float32))


def test_summary_and_warmup():
    _, tm, _ = _models("custom8", dict())
    assert "custom8" in tm.summary() and "cpu" in tm.summary()
    tm.warmup(batch=3)
    assert dataclasses.is_dataclass(tm.packed.stages[0])
