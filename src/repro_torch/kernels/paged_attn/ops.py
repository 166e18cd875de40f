"""Dispatch of the paged-attention decode read.

Counterpart of ``repro/kernels/paged_attn/ops.py``.  A CUDA tensor
launches the hand-written kernel (kernel.py) and a CPU tensor takes the
plain version (ref.py), as the reference takes its oracle off the TPU.
``use_kernel=False`` takes the plain version on the card too: the
comparison runs set it through ``ModelConfig.paged_attn_use_kernel``.
"""
from __future__ import annotations

from typing import Optional

import torch

# module imports: ref.py and models/layers.py import each other's modules
from . import ref
from .kernel import paged_attention_cuda


def paged_attention_decode(
    q: torch.Tensor,              # (B, Hq, Dh)
    k_pool: torch.Tensor,         # (n_blocks, bs, Hkv, Dh)
    v_pool: torch.Tensor,         # (n_blocks, bs, Hkv, Dh)
    table: torch.Tensor,          # (B, n_tbl) int32
    lengths: torch.Tensor,        # (B,) int32 valid kv rows (incl. current)
    is_local: bool = False,
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """-> (B, Hq, Dh).  ``use_kernel`` None: the kernel for CUDA tensors,
    the plain version for CPU tensors; False: the plain version; True on
    a CPU tensor raises."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel and not q.is_cuda:
        raise ValueError("the CUDA kernel takes CUDA tensors; CPU tensors "
                         "run the plain version (use_kernel=None)")
    if not use_kernel:
        return ref.paged_attention_ref(q, k_pool, v_pool, table, lengths,
                                       softcap=softcap, window=window,
                                       is_local=is_local)
    return paged_attention_cuda(q.contiguous(), k_pool, v_pool,
                                table.to(torch.int32).contiguous(),
                                lengths.to(torch.int32).contiguous(),
                                is_local, softcap=softcap, window=window)
