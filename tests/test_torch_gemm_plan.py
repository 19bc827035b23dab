"""``crossbar_gemm``'s exact-branch plan and the ``gemm.x_load_bytes``
counter, on the CPU.

``exact_plan(S, M, N, kk)`` picks, from the shape alone, the 64 x 64
tiles (the slice axis; a K split where the tiles fill at most a quarter
of the SMs) or the wide persistent tiles of a 2-D call that fills the
card, whose N-first order reads each x strip from device memory once.
The kernel itself is held on the card (``test_torch_cuda.py``'s
``test_crossbar_gemm_exact_plans``).
"""

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch import trace
from repro_torch.kernels.crossbar_gemm import (ExactPlan, SM_COUNT,
                                               exact_plan, tile64_plan,
                                               x_load_bytes)
from repro_torch.program import execute


# (S, M, N, kk, splits): the 64 x 64 plan of calls whose tiles fill at most
# a quarter of the SMs, with the K split the kernel took before the wide
# tiles existed (ResNet-18 s3 at b16, a one-row fc, AlexNet-like ragged
# widths, short K, the b16 head of vit_s16, and a call that fills more)
SMALL = [(1, 256, 512, 4608, 5), (1, 1, 10, 4864, 19), (1, 16, 77, 1472, 6),
         (1, 1024, 10, 512, 1), (1, 16, 1000, 384, 1),
         (1, 2048, 512, 4608, 1), (5, 16, 19, 1024, 4)]


@pytest.mark.parametrize("S,M,N,kk,splits", SMALL)
def test_small_calls_keep_the_64_tiles_and_their_k_split(S, M, N, kk,
                                                         splits):
    assert exact_plan(S, M, N, kk) == ExactPlan(64, 64, splits)
    assert tile64_plan(S, M, N, kk) == ExactPlan(64, 64, splits)


@pytest.mark.parametrize("N", [10, 64, 128, 192, 196, 256])
@pytest.mark.parametrize("M", [200704, 1048576, 33000])
def test_one_column_tile_where_n_fits_and_m_fills_the_card(M, N):
    plan = exact_plan(1, M, N, 384)
    assert plan.bm == 128 and plan.splits == 1
    assert plan.bn >= N and -(-N // plan.bn) == 1
    assert x_load_bytes(1, M, N, 384) == M * 384


@pytest.mark.parametrize("N,bn,columns", [(384, 192, 2), (512, 256, 2),
                                          (576, 192, 3), (1000, 256, 4),
                                          (1152, 256, 5), (1536, 256, 6)])
def test_wider_n_takes_the_fewest_column_tiles(N, bn, columns):
    """ceil(N / 256) column tiles, at the width that pads N least."""
    plan = exact_plan(1, 200704, N, 768)
    assert plan == ExactPlan(128, bn, 1)
    assert -(-N // bn) == columns == -(-N // 256)
    assert x_load_bytes(1, 200704, N, 768) == 200704 * 768 * columns


@pytest.mark.parametrize("S,M,N,kk", [(6144, 196, 196, 64),
                                      (6144, 196, 64, 224),
                                      (3072, 64, 64, 64)])
def test_slice_calls_keep_the_64_tiles(S, M, N, kk):
    """Attention's scores and contexts: their x strip is read once."""
    assert exact_plan(S, M, N, kk) == ExactPlan(64, 64, 1)
    assert x_load_bytes(S, M, N, kk) == S * M * kk * -(-N // 64)


@pytest.mark.parametrize("M,wide", [(128 * SM_COUNT, True),
                                    (128 * SM_COUNT - 127, True),
                                    (128 * SM_COUNT - 128, False),
                                    (128 * (SM_COUNT + 1), True),
                                    (128 * 280, True),
                                    (128 * 2 * SM_COUNT, True)])
def test_wide_tiles_only_where_their_rounds_fill_the_card(M, wide):
    """At least one tile an SM: 131 tiles would leave an SM idle, so such
    a call keeps the 64 x 64 tiles; past the first round, the wide tiles
    run no slower than the 64 x 64 ones whatever the last round holds
    (133 and 280 tiles on 132 SMs, PERF.md section 5)."""
    assert (exact_plan(1, M, 64, 576).bm == 128) == wide


def _tokens_net():
    nb = api.NetworkBuilder("xload", input_seq_dim=64)
    nb.linear(384, name="up")
    nb.relu(name="r")
    nb.linear(10, name="down")
    return nb.build()


@pytest.mark.parametrize("batch,T", [(2, 8448), (1, 8)])
def test_x_load_bytes_through_the_static_stages(batch, T):
    """Two token stages at M = batch * T: at 16,896 rows both take wide
    tiles (N 384 in two 192-wide column tiles, N 10 in one), where the
    64 x 64 tiles would load x six times and once; at 8 rows both keep
    the 64 x 64 tiles."""
    model = api.compile(_tokens_net(), api.HurryConfig(), seed=3,
                        device="cpu")
    x = np.random.default_rng(batch).standard_normal(
        (batch, T, 64)).astype(np.float32)
    trace.reset()
    execute.execute_packed(model.packed, torch.from_numpy(x))
    M = batch * T
    got = trace.counters()[execute.X_LOAD_BYTES]
    if M >= 128 * SM_COUNT:
        assert got == M * 64 * 2 + M * 384 * 1
    else:
        assert got == M * 64 * 6 + M * 384 * 1
    assert got == x_load_bytes(1, M, 384, 64) + x_load_bytes(1, M, 10, 384)
