"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: they build the kernels with ``nvcc`` and launch them,
so they skip on a host without a GPU.  On the GPU machine (which has no
JAX) run them with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch, numpy and repro_torch only.
"""

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.kernels import (clip_possible, crossbar_gemm,
                                 crossbar_gemm_exact_ref, crossbar_gemm_ref,
                                 fb_epilogue, fb_epilogue_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels are CUDA C++)")
    return torch.device("cuda")


def _int8(shape, rng):
    return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("adc_bits,rows,exact", [
    (9, 494, None), (9, 27, None), (8, 494, None), (9, 512, None),
    (9, 255, False), (8, 486, False)])
def test_crossbar_gemm_kernel_equals_plain(cuda, adc_bits, rows, exact):
    rng = np.random.default_rng(rows)
    x, w = _int8((133, 1001), rng).to(cuda), _int8((1001, 70), rng).to(cuda)
    x[:33] = -1          # all bits set: bitline counts reach `rows`
    w[:, :17] = -1
    before = crossbar_gemm.launches
    got = crossbar_gemm(x, w, adc_bits=adc_bits, rows=rows, exact=exact)
    assert crossbar_gemm.launches == before + 1
    sliced = exact is False or clip_possible(rows, adc_bits)
    ref = (crossbar_gemm_ref(x, w, adc_bits=adc_bits, rows=rows) if sliced
           else crossbar_gemm_exact_ref(x, w))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# (kwargs, residual?, atol) — 0 is bit for bit: same roundings in the same
# order; elsewhere the kernel's block reductions sum in another order
FB_CASES = {
    "none": (dict(), False, 0.0),
    "relu+residual": (dict(act="relu"), True, 0.0),
    "post_scale": (dict(post_scale=0.125), False, 0.0),
    "maxpool": (dict(act="relu", pool="max", window=2, img_hw=8), True, 0.0),
    "avgpool": (dict(act="relu", pool="avg", window=4, img_hw=8), True, 0.0),
    "gelu": (dict(act="gelu"), False, 1e-6),
    "layer": (dict(norm="layer"), True, 1e-5),
    "seqmean": (dict(act="gelu", norm="layer", pool="seqmean", window=16),
                True, 1e-5),
    "softmax": (dict(softmax=True), False, 1e-6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(FB_CASES))
def test_fb_epilogue_kernel_matches_plain(cuda, mode):
    kw, with_res, atol = FB_CASES[mode]
    g = torch.Generator(device=cuda).manual_seed(0)
    M, N = 2 * 64, 48
    y = torch.randint(-2 ** 20, 2 ** 20, (M, N), generator=g, device=cuda,
                      dtype=torch.int32)
    scale = torch.full((1, 1), 3.1e-6, device=cuda)
    bias = torch.randn(N, generator=g, device=cuda)
    res = torch.randn(M, N, generator=g, device=cuda) if with_res else None
    if "norm" in kw:
        kw = dict(kw, gamma=torch.randn(N, generator=g, device=cuda),
                  beta=torch.randn(N, generator=g, device=cuda))
    before = fb_epilogue.launches
    got = fb_epilogue(y, scale, bias, res, **kw)
    assert fb_epilogue.launches == before + 1
    ref = fb_epilogue_ref(y, scale, bias, res, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=0, atol=atol)


@pytest.mark.cuda
def test_small_net_on_the_gpu_equals_the_cpu_plain_path(cuda):
    nb = api.NetworkBuilder("tiny", input_hw=8, input_ch=3)
    nb.conv(16, name="c1")
    r1 = nb.relu(name="r1")
    nb.conv(16, name="c2")
    nb.residual(r1, name="res")
    nb.relu(name="r2")
    nb.maxpool(name="p")
    nb.fc(10, name="fc")
    nb.softmax(name="sm")
    graph = nb.build()
    gpu = api.compile(graph, seed=2, device="cuda")
    cpu = api.compile(graph, seed=2, device="cpu")
    x = np.random.default_rng(0).standard_normal((5, 8, 8, 3)).astype(
        np.float32)
    assert torch.equal(gpu.run(x, logits=True).cpu(), cpu.run(x, logits=True))
