"""Plain oracle of the W8A8 GEMM: ``repro/kernels/int8_matmul/ref.py``.

The int32 dot is exact (``core.ccim.int_matmul_exact``: int64 on the
CPU, float64 on CUDA, never float32, whose 24-bit significand K * 127^2
passes from K = 1,041).  The dequant is the reference's, left to right:
float32(acc) * sx * sw.
"""
from __future__ import annotations

import torch

from ...core.ccim import int_matmul_exact


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                    sw: torch.Tensor) -> torch.Tensor:
    """x_q (M, K) and w_q (K, N) ints, sx (M, 1) and sw (1, N) scales ->
    (M, N) float32."""
    return int_matmul_exact(x_q, w_q).to(torch.float32) * sx * sw
