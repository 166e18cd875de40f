"""Hopper CUDA kernel of the paged-attention decode read.

``paged_attention_cuda`` launches ``csrc/paged_attn_decode.cu``, the port
of ``repro/kernels/paged_attn/kernel.py::paged_attention_pallas``: one
query per row against the KV rows its block table names, with a float32
online softmax and float32 P.V, output rounded to q's dtype once.  The
source is built and loaded by ``kernels/build.py``; the wrapper counts
its launches in ``.launches``.  The plain version is ``ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import build

MAX_GROUP = 16            # query heads per kv head (the kernel's register tile)
HEAD_DIMS = (64, 128)
_SMEM_LIMIT = 48 * 1024

_fn = []


def _entry():
    if not _fn:
        fn = build.library("paged_attn").paged_attn_decode
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _check(q, k_pool, v_pool, table, lengths) -> None:
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("k_pool", k_pool, torch.bfloat16),
                        ("v_pool", v_pool, torch.bfloat16),
                        ("table", table, torch.int32),
                        ("lengths", lengths, torch.int32)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Hq, Dh = q.shape
    nb, bs, Hkv, Dh2 = k_pool.shape
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v_pool {tuple(v_pool.shape)} != k_pool "
                         f"{tuple(k_pool.shape)}")
    if Dh2 != Dh or Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} (pool {Dh2}): the kernel takes "
                         f"{HEAD_DIMS}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads: the kernel "
                         f"takes groups of at most {MAX_GROUP}")
    if table.dim() != 2 or table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"table {tuple(table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    G = Hq // Hkv
    if 4 * (G * Dh + G * bs + 3 * G) > _SMEM_LIMIT:
        raise ValueError(f"block size {bs} with {G} heads per group needs "
                         "more than 48 KB of shared memory")


def paged_attention_cuda(
    q: torch.Tensor,              # (B, Hq, Dh) bf16
    k_pool: torch.Tensor,         # (n_blocks, bs, Hkv, Dh) bf16
    v_pool: torch.Tensor,         # (n_blocks, bs, Hkv, Dh) bf16
    table: torch.Tensor,          # (B, n_tbl) int32
    lengths: torch.Tensor,        # (B,) int32, each >= 1
    is_local: bool = False,
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Paged decode attention on the card -> (B, Hq, Dh) bf16.  Block ids
    outside the pool are clamped into it; table entries past
    ceil(lengths[b] / bs) are never read."""
    _check(q, k_pool, v_pool, table, lengths)
    B, Hq, Dh = q.shape
    nb, bs, Hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # the reference's Python-float scale, as the float32 it becomes
    scale = float(np.float32(Dh ** -0.5))
    err = _entry()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                   B, Hq, Hkv, Dh, bs, table.shape[1], nb, scale,
                   float(softcap or 0.0), int(window or 0), int(bool(is_local)),
                   stream)
    if err:
        raise RuntimeError(f"paged_attn_decode launch failed: CUDA error {err}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def reset_launch_counts() -> None:
    paged_attention_cuda.launches = 0
