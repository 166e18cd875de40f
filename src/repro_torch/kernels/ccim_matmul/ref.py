"""Integer oracle for the hybrid-CIM GEMM kernels (prototype split).

Counterpart of ``repro/kernels/ccim_matmul/ref.py``: the 28nm prototype's
ideal-analog arithmetic written straight from the definition -- top-3
DCIM as three signed MSB bit-plane dots 2*x6.w6 + x6.w5 + x5.w6, the ADC
as an integer floor division -- in int64, independently of the kernel
module and its folded planes, so the tests compare two implementations.
The chunk dots go through ``core.ccim.int_matmul_exact`` (int64 on the
CPU, float64 on CUDA, whose GEMMs take no integers; exact either way).
"""
from __future__ import annotations

import torch

from ...core.ccim import int_matmul_exact

ACC_LEN = 16
DCIM_LSB = 2048
ADC_HALF = 64


def ccim_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int @ (K, N) int -> (M, N) int32 at product scale."""
    M, K = x_q.shape
    _, N = w_q.shape
    assert K % ACC_LEN == 0, K
    C = K // ACC_LEN
    x = x_q.to(torch.int64).reshape(M, C, ACC_LEN)
    w = w_q.to(torch.int64).reshape(C, ACC_LEN, N)

    sx, mx = torch.where(x < 0, -1, 1), x.abs()
    sw, mw = torch.where(w < 0, -1, 1), w.abs()
    x6, x5 = sx * ((mx >> 6) & 1), sx * ((mx >> 5) & 1)
    w6, w5 = sw * ((mw >> 6) & 1), sw * ((mw >> 5) & 1)

    dot = lambda a, b: int_matmul_exact(a.transpose(0, 1), b).transpose(
        0, 1).to(torch.int64)                          # (M, C, N) chunk dots
    exact = dot(x, w)
    dcim = 2 * dot(x6, w6) + dot(x6, w5) + dot(x5, w6)
    acim = exact - dcim * DCIM_LSB
    code = torch.clamp(torch.div(acim + DCIM_LSB // 2, DCIM_LSB,
                                 rounding_mode="floor"),
                       -ADC_HALF, ADC_HALF - 1)
    return ((dcim + code).sum(dim=1) * DCIM_LSB).to(torch.int32)
