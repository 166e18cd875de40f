"""W8A8 GEMM with dynamic quantization: ``repro/kernels/int8_matmul/ops.py``.

``int8_matmul(x, w)`` quantizes x per row and w per column to int8, then
runs the integer GEMM with the fused dequant: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.  The rounding points are
the reference's under ``jax.jit``: the scale max(|v|, 1e-12) / 127 is
formed as a multiply by the float32 reciprocal (XLA folds the divide by
a constant into it), ``v / s`` stays a true divide (a divide by an
array), and ``torch.round`` rounds half to even as ``jnp.round`` does.
A bfloat16 input is quantized with its scale rounded to bfloat16 and
quotients rounded per op, but dequantized with the scale unrounded, in
float32: XLA recomputes the cheap scale inside the fused dequant and
drops the round trip through bfloat16 there (both of the reference's
routes, the plain one and the Pallas kernel's, do this).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ccim_matmul.ops import _pad_to, resolve_use_kernel
from .kernel import K_STEP, int8_w8a8_cuda
from .ref import int8_matmul_ref

_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def dynamic_quantize(v: torch.Tensor, dim: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, s): ``v`` quantized symmetrically to int8 in [-127, 127] with
    one scale per slice along ``dim`` (keepdim); q from the scale in v's
    dtype, s the float32 dequant scale (the same value for float32)."""
    amax = v.abs().amax(dim=dim, keepdim=True)
    q = torch.round(v / (torch.clamp_min(amax, 1e-12) * _INV_127))
    s = torch.clamp_min(amax.to(torch.float32), 1e-12) * _INV_127
    return torch.clamp(q, -127, 127).to(torch.int8), s


def kernel_operands(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                    sw: torch.Tensor):
    """The kernel's operands from quantized (M, K) x and (K, N) w and their
    keepdim scales: x (M, Kp), w transposed to (N, Kp), K zero-padded to
    ``K_STEP``, and the scales flat."""
    pad = _pad_to(xq.shape[1], K_STEP) - xq.shape[1]
    return (F.pad(xq, (0, pad)).contiguous(),
            F.pad(wq.t(), (0, pad)).contiguous(),
            sx.reshape(-1).contiguous(), sw.reshape(-1).contiguous())


def int8_matmul(x: torch.Tensor, w: torch.Tensor, *,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
    """float (M, K) @ (K, N) -> (M, N) float32 with dynamic per-row and
    per-column int8 quantization.  ``use_kernel`` None launches the CUDA
    kernel for CUDA tensors (one launch per call) and runs the plain
    version for CPU tensors; False forces the plain version; True on a
    CPU tensor raises."""
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)}")
    xq, sx = dynamic_quantize(x, -1)
    wq, sw = dynamic_quantize(w, 0)
    if not resolve_use_kernel(use_kernel, x):
        return int8_matmul_ref(xq, wq, sx, sw)
    return int8_w8a8_cuda(*kernel_operands(xq, sx, wq, sw))
