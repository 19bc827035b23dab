"""Static stages' ``crossbar_gemm`` operands at ``pack.layout_k``.

On the exact branch (no ADC clip possible) a weight-mounted stage lays
its left operand and its mounted ``wt`` out at up32(logical K), not at
the K of its whole mounts: the zero rows of a part-filled mount add
nothing to an int32 sum.  On the sliced branch the chunk-by-chunk
layout of the full mounts stays.  Held here on the CPU: the zoo's four
networks against the JAX executor and against the full-mount layout,
the loader's ``wt``, and the ``layout.zero_k_bytes`` counter.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import api as tapi
from repro_torch import trace
from repro_torch.kernels import clip_possible, mount_weight
from repro_torch.program import execute
from repro_torch.program.pack import layout_k, logical_k

from test_torch_program import AVGPOOL_REL, _models, _x
from test_torch_sequence import SEQ_REL


def _up32(n):
    return -(-n // 32) * 32


def _spied_stages(monkeypatch):
    """Per static stage the executor runs: its op, its packed stage, its
    ``quantize_layout`` call (K, output), its ``crossbar_gemm`` keyword
    arguments and the ``layout.zero_k_bytes`` it added."""
    recs = []
    real = (execute._static_stage, execute.quantize_layout,
            execute.crossbar_gemm)

    def stage(gemm, posts, st, bufs, cfg, **kw):
        before = trace.counters().get(execute.ZERO_K_BYTES, 0)
        recs.append(dict(gemm=gemm, st=st))
        out = real[0](gemm, posts, st, bufs, cfg, **kw)
        recs[-1]["zero_k"] = (trace.counters()[execute.ZERO_K_BYTES]
                              - before)
        return out

    def quant(xin, K, **kw):
        out = real[1](xin, K, **kw)
        if recs and "w_amax" in kw and not kw.get("per_slice"):
            recs[-1]["quant"] = (K, out[0])
        return out

    def gemm(x8, w8=None, **kw):
        if recs and "gemm_kw" not in recs[-1] and "quant" in recs[-1]:
            recs[-1]["gemm_kw"] = (w8, kw)
        return real[2](x8, w8, **kw)

    monkeypatch.setattr(execute, "_static_stage", stage)
    monkeypatch.setattr(execute, "quantize_layout", quant)
    monkeypatch.setattr(execute, "crossbar_gemm", gemm)
    return recs


def _full_mounts(monkeypatch, packed):
    """The layout before ``layout_k``: every static stage's operands at
    the K of its whole mounts (a ``PackedProgram`` with that ``wt``, and
    the executor's ``layout_k`` patched to match)."""
    cfg = packed.program.cfg
    stages = tuple(
        st if gemm.kind == "dyn_gemm" else dataclasses.replace(
            st, wt=mount_weight(st.w8, rows=gemm.tile_rows,
                                adc_bits=cfg.adc_bits))
        for (gemm, _), st in zip(packed.program.stages(), packed.stages))
    def full_k(gemm, adc_bits):
        return -(-logical_k(gemm) // gemm.tile_rows) * gemm.tile_rows

    monkeypatch.setattr(execute, "layout_k", full_k)
    return dataclasses.replace(packed, stages=stages)


@pytest.mark.parametrize("net", ["resnet18", "vit_tiny", "alexnet", "vgg16"])
def test_exact_stages_take_up32_of_the_logical_k(net, monkeypatch):
    """The zoo at the default ``HurryConfig`` (every static stage on the
    exact branch): each stage's ``quantize_layout`` output and ``wt``
    share Kk = up32(logical K), ``crossbar_gemm`` gets that K and ``wt``
    and no (K, N) weight, ``layout.zero_k_bytes`` is only up32's
    remainder, M * (Kk - K); the logits equal the full-mount layout's
    bit for bit and the JAX executor's (bit for bit where no average
    pool or softmax comes first)."""
    jm, tm, _ = _models(net, dict())
    cfg = tm.program.cfg
    x = _x(jm.graph, 2)
    xt = torch.from_numpy(x)
    recs = _spied_stages(monkeypatch)
    got = execute.execute_packed(tm.packed, xt, return_logits=True)
    static = [(g, st) for (g, _), st in zip(tm.program.stages(),
                                            tm.packed.stages)
              if g.kind != "dyn_gemm"]
    assert [r["gemm"] for r in recs] == [g for g, _ in static]
    for r in recs:
        gemm, st = r["gemm"], r["st"]
        k = logical_k(gemm)
        assert not clip_possible(gemm.tile_rows, cfg.adc_bits)
        assert layout_k(gemm, cfg.adc_bits) == k
        K, xq = r["quant"]
        assert K == k and st.wt.shape == (st.w8.shape[1], _up32(k))
        assert xq.shape[-1] == _up32(k)
        w8, kw = r["gemm_kw"]
        assert w8 is None and kw["K"] == k and kw["wt"] is st.wt
        assert r["zero_k"] == xq.shape[0] * (_up32(k) - k)
        assert r["zero_k"] < 32 * xq.shape[0]
    monkeypatch.undo()
    full = execute.execute_packed(_full_mounts(monkeypatch, tm.packed), xt,
                                  return_logits=True)
    assert torch.equal(got, full)
    ref = np.asarray(jm.run(jnp.asarray(x), logits=True))
    got = got.numpy()
    if net in ("alexnet", "vgg16"):
        np.testing.assert_array_equal(got, ref)
    else:
        assert (got.argmax(1) == ref.argmax(1)).all()
        rel = AVGPOOL_REL if net == "resnet18" else SEQ_REL
        assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


def _k576():
    """A 3x3 conv over 64 channels (K = 576 on two 494-row mounts, 988
    rows) and an fc."""
    nb = tapi.NetworkBuilder("k576", input_hw=4, input_ch=64)
    nb.conv(64, name="c")
    nb.relu(name="r")
    nb.fc(10, name="fc")
    return nb.build()


@pytest.mark.parametrize("cfg_kw,branch", [(dict(), "exact"),
                                           (dict(adc_bits=8), "sliced")])
def test_zero_k_bytes_of_an_exact_and_a_sliced_stage(cfg_kw, branch,
                                                     monkeypatch):
    """A conv of K = 576 on two 494-row mounts: on the exact branch its
    operand carries no zero column (576 is a multiple of 32), where the
    full mounts' layout carried up32(988) - 576 = 416 a row; on the
    sliced branch (an 8-bit ADC) the two mounts chunk by chunk, 2 *
    up32(494) - 576 = 448 a row, as before."""
    model = tapi.compile(_k576(), tapi.HurryConfig(**cfg_kw), seed=2,
                         device="cpu")
    trace.reset()
    recs = _spied_stages(monkeypatch)
    execute.execute_packed(model.packed, torch.from_numpy(_x(model.graph,
                                                             3)))
    gemm, st = recs[0]["gemm"], recs[0]["st"]
    assert (gemm.name, logical_k(gemm), gemm.tile_rows) == ("c", 576, 494)
    assert st.w8.shape[0] == 988
    M = 3 * gemm.out_hw ** 2
    K, xq = recs[0]["quant"]
    if branch == "exact":
        assert K == 576 and xq.shape[-1] == 576
        assert recs[0]["zero_k"] == 0
    else:
        assert clip_possible(494, 8) and K == 988
        assert xq.shape[-1] == st.wt.shape[-1] == 1024
        assert recs[0]["zero_k"] == M * (1024 - 576) == M * 448
    assert trace.counters()[execute.ZERO_K_BYTES] == sum(
        r["zero_k"] for r in recs)


@pytest.mark.parametrize("net,cfg_kw", [("resnet18", dict()),
                                        ("alexnet", dict(adc_bits=8))])
def test_a_saved_model_reloads_the_same_wt(net, cfg_kw, tmp_path):
    """``save`` keeps the full-mount planes (``w8``, K_pad rows); ``load``
    mounts the same ``wt`` from them as ``pack_program`` did, at
    up32(logical K) on the exact stages and chunk by chunk on the sliced
    ones (AlexNet at an 8-bit ADC)."""
    model = tapi.compile(net, tapi.HurryConfig(**cfg_kw), seed=4,
                         device="cpu")
    loaded = tapi.load(model.save(str(tmp_path / "m.npz")), device="cpu")
    adc = model.program.cfg.adc_bits
    kinds = set()
    for (gemm, _), a, b in zip(model.program.stages(), model.packed.stages,
                               loaded.packed.stages):
        assert torch.equal(a.w8, b.w8) and a.w8.shape[0] % gemm.tile_rows == 0
        assert torch.equal(a.wt, b.wt) and b.wt.is_contiguous()
        k = logical_k(gemm)
        if clip_possible(gemm.tile_rows, adc):
            kinds.add("sliced")
            chunks = a.w8.shape[0] // gemm.tile_rows
            assert b.wt.shape[-1] == chunks * _up32(gemm.tile_rows)
        else:
            kinds.add("exact")
            assert b.wt.shape[-1] == _up32(k)
    assert kinds == ({"exact", "sliced"} if cfg_kw else {"exact"})
