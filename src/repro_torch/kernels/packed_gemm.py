"""Packed (grouped, MoE-expert) GEMM: the BAS block-packing analogue.

The port of ``repro.kernels.packed_gemm`` (the Pallas kernel and its host
helpers ``pad_groups`` and ``tile_group_map``) and of its oracle
``repro.kernels.ref.packed_gemm_ref``.  Rows arrive sorted by group;
``pad_groups`` pads each group to a multiple of ``block_m`` (zero rows),
``tile_group_map`` names each ``block_m``-row tile's group, and
``packed_gemm`` multiplies every tile by its group's (K, N) weight with
float32 accumulation, in x's type.  The helpers return what the JAX ones
return, as int32 tensors.

For a CUDA tensor ``packed_gemm`` launches the hand-written kernel in
``csrc/packed_gemm.cu`` and counts it in ``launches.packed_gemm``
(``repro_torch.trace``); for a CPU tensor it computes the plain PyTorch version
``packed_gemm_tiles_ref``.  Nothing falls back from the card to the
plain version.

On the H100 the kernel is bound by latency and by how many of the 132
SMs it keeps busy, not by its products (its header says why).  It runs
the products on the tensor cores (3xTF32 for float32, bf16 ``mma``),
with K whole, and ``packed_tile`` cuts the output into blocks that never
span two ``block_m`` tiles, narrow enough to give the SMs work.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import trace

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SM_COUNT = 132           # H100 SXM


def packed_tile(block_m: int, Mp: int, N: int) -> tuple[int, int]:
    """The kernel's (rows, columns) block tile for ``Mp`` rows in
    ``block_m``-row tiles: rows the largest of 64 / 32 / 16 that divides
    ``block_m``, so a block never spans two tiles (where none divides,
    the smallest of them that covers ``block_m``, up to 64, and the
    kernel masks each tile's last block at the boundary); columns 32
    where 64-column blocks would number under twice the SMs, else 64.
    A function of the shape alone."""
    bm = next((t for t in (64, 32, 16) if block_m % t == 0),
              next((t for t in (16, 32) if block_m <= t), 64))
    blocks_64 = -(-Mp // block_m) * -(-block_m // bm) * -(-N // 64)
    return bm, 32 if blocks_64 < 2 * SM_COUNT else 64


def tile_group_map(group_sizes, block_m: int, n_tiles: int) -> torch.Tensor:
    """Host-side plan: group id per ``block_m``-row tile, int32.

    ``group_sizes`` must already be multiples of ``block_m``
    (``pad_groups``' ``padded_sizes``).  As ``jnp.repeat`` with
    ``total_repeat_length`` does, the map is cut at ``n_tiles`` or
    filled up to it with the last group's id.
    """
    sizes = np.asarray(group_sizes).reshape(-1)
    gid = np.repeat(np.arange(len(sizes)), sizes // block_m)[:n_tiles]
    gid = np.pad(gid, (0, n_tiles - len(gid)),
                 constant_values=len(sizes) - 1)
    return torch.from_numpy(gid.astype(np.int32))


def pad_groups(x: torch.Tensor, group_sizes, block_m: int):
    """Pad each group's rows to a multiple of ``block_m`` (zero rows).

    Returns ``(x_padded, padded_sizes, row_index, inv_index)``:
    ``row_index`` maps padded rows to original rows (-1 for padding),
    ``inv_index`` maps original rows to padded rows, planned on the host
    once so the caller unpads with one gather.  All three are int32;
    ``padded_sizes`` stays on the host, where ``tile_group_map`` reads
    it, and the index tensors are on x's device.
    """
    sizes = np.asarray(group_sizes).reshape(-1)
    padded = (sizes + block_m - 1) // block_m * block_m
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    out_rows = int(padded.sum())
    row_index = np.full((out_rows,), -1, np.int32)
    o = 0
    for st, sz, pd in zip(starts, sizes, padded):
        row_index[o:o + sz] = np.arange(st, st + sz)
        o += pd
    real = row_index >= 0
    inv = np.zeros((x.shape[0],), np.int32)
    inv[row_index[real]] = np.arange(out_rows)[real]
    idx = torch.from_numpy(row_index).to(x.device)
    xp = torch.where(idx[:, None] >= 0, x[idx.clamp_min(0).long()],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    return (xp, torch.from_numpy(padded.astype(np.int32)), idx,
            torch.from_numpy(inv).to(x.device))


def packed_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                    group_sizes) -> torch.Tensor:
    """x (T, K) rows sorted by group; w (G, K, N); group_sizes (G,).

    Row t belongs to group g iff cum[g-1] <= t < cum[g] (past the last
    bound: group G-1); ``y[t] = x[t] @ w[group(t)]``.
    """
    G = w.shape[0]
    bounds = torch.cumsum(torch.as_tensor(group_sizes, device=x.device), 0)
    rows = torch.arange(x.shape[0], device=x.device)
    gid = torch.searchsorted(bounds, rows, right=True).clamp_max(G - 1)
    return _grouped_rows(x, w, gid)


def packed_gemm_tiles_ref(x: torch.Tensor, w: torch.Tensor,
                          tile_groups: torch.Tensor,
                          block_m: int) -> torch.Tensor:
    """The plain version of the kernel: ``block_m``-row tile i of x
    times ``w[tile_groups[i]]``, float32 accumulation, in x's type."""
    gid = tile_groups.to(x.device).long().repeat_interleave(block_m)
    return _grouped_rows(x, w, gid[:x.shape[0]])


def _grouped_rows(x: torch.Tensor, w: torch.Tensor,
                  gid: torch.Tensor) -> torch.Tensor:
    """``y[t] = x[t] @ w[gid[t]]`` in float32, one product per group."""
    y = torch.zeros(x.shape[0], w.shape[2], dtype=torch.float32,
                    device=x.device)
    for g in torch.unique(gid).tolist():
        rows = gid == g
        y[rows] = x[rows].float() @ w[g].float()
    return y.to(x.dtype)


def _check(x, w, tile_groups, block_m: int, block_n: int) -> int:
    """Validate like the JAX wrapper; returns the effective block_m."""
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"packed_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (Mp, K) and (G, K, N)")
    M, N = x.shape[0], w.shape[2]
    bm, bn = min(block_m, M), min(block_n, N)
    if bm < 1 or bn < 1 or M % bm or N % bn:
        raise ValueError(f"packed_gemm: ({M}, {N}) is not a multiple of the "
                         f"blocks ({bm}, {bn})")
    if tuple(tile_groups.shape) != (M // bm,):
        raise ValueError(f"packed_gemm: tile_groups {tuple(tile_groups.shape)}"
                         f" is not one id per {bm}-row tile ({M // bm},)")
    if tile_groups.numel() and (int(tile_groups.min()) < 0
                                or int(tile_groups.max()) >= w.shape[0]):
        raise ValueError(f"packed_gemm: tile_groups outside [0, "
                         f"{w.shape[0]})")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"packed_gemm takes float32 or bfloat16 x and w of "
                        f"one type, got {x.dtype}, {w.dtype}")
    if w.device != x.device:
        raise ValueError("packed_gemm: x and w on different devices")
    return bm


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry's argument and result types on a loaded
    ``packed_gemm`` library (also a variant build of it)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.packed_gemm.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.packed_gemm.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return declare(_build.load("packed_gemm"))


def _launch(x, w, tile_groups, block_m: int) -> torch.Tensor:
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("packed_gemm: the CUDA kernel takes contiguous "
                         "x and w")
    M, K = x.shape
    N = w.shape[2]
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    tg = tile_groups.to(device=x.device, dtype=torch.int32).contiguous()
    tm, tn = packed_tile(block_m, M, N)
    lib = _lib()
    err = lib.packed_gemm(x.data_ptr(), w.data_ptr(), tg.data_ptr(),
                          out.data_ptr(), M, N, K, block_m, tm, tn,
                          _DTYPES[x.dtype], _build.stream_handle())
    _build.check(lib, "packed_gemm", err)
    trace.count("launches.packed_gemm")
    return out


def packed_gemm(x: torch.Tensor, w: torch.Tensor, tile_groups: torch.Tensor,
                *, block_m: int = 128, block_n: int = 128) -> torch.Tensor:
    """x (Mp, K) group-sorted and padded; w (G, K, N); tile_groups
    (Mp / block_m,) int -> (Mp, N) in x's type.

    ``block_n`` decides only which N are accepted (as in JAX).  CUDA
    tensors run the kernel, CPU tensors the plain version.
    """
    tile_groups = torch.as_tensor(tile_groups)
    bm = _check(x, w, tile_groups, block_m, block_n)
    if x.is_cuda:
        return _launch(x, w, tile_groups, bm)
    return packed_gemm_tiles_ref(x, w, tile_groups, bm)
