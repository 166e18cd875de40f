"""Public wrappers of the fused complex hybrid-CIM GEMM kernels.

Counterpart of ``repro/kernels/ccim_complex/ops.py``.  The weights keep
the port's layouts (``kernels/ccim_matmul/ops.py``): a prepacked pair is
two real packs, w (N, Kp) and planes (2, N, Kp) each, with N unpadded;
raw weights are cast to int8 once with K padded to whole chunks.
``use_kernel`` None launches a CUDA kernel for CUDA tensors and runs the
plain version for CPU tensors; False forces the plain version; True on a
CPU tensor raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ccim_matmul.ops import (_pad_to, pad_k_int8, resolve_use_kernel,
                               weight_layout)
from ..ccim_matmul.ref import ACC_LEN
from .kernel import (SKINNY_M, Pair, ccim_complex_prepacked_general_cuda,
                     ccim_complex_prepacked_plain,
                     ccim_complex_prepacked_skinny_cuda,
                     ccim_complex_unpacked_cuda, ccim_complex_unpacked_plain)


def ccim_complex_matmul_int(
    x_re: torch.Tensor, x_im: torch.Tensor,    # (M, K) ints in [-127, 127]
    w_re: torch.Tensor, w_im: torch.Tensor,    # (K, N) ints, co-located
    *, use_kernel: Optional[bool] = None,
) -> Pair:
    """Integer complex GEMM on raw weights -> (y_re, y_im) int32 at x 2^11."""
    M, K = x_re.shape
    if x_im.shape != (M, K) or w_re.shape[0] != K or w_im.shape != w_re.shape:
        raise ValueError(f"x {tuple(x_re.shape)}/{tuple(x_im.shape)} @ w "
                         f"{tuple(w_re.shape)}/{tuple(w_im.shape)}")
    Kp = _pad_to(K, ACC_LEN)
    xr, xi = pad_k_int8(x_re, Kp, 1), pad_k_int8(x_im, Kp, 1)
    wr, wi = pad_k_int8(w_re, Kp, 0), pad_k_int8(w_im, Kp, 0)
    if resolve_use_kernel(use_kernel, x_re):
        return ccim_complex_unpacked_cuda(xr, xi, wr, wi)
    return ccim_complex_unpacked_plain(xr, xi, wr, wi)


def ccim_complex_matmul_int_prepacked(
    x_re: torch.Tensor, x_im: torch.Tensor,    # (M, K) ints in [-127, 127]
    w_re: torch.Tensor, w_im: torch.Tensor,    # (N, Kp) int8, packed
    planes_re: torch.Tensor, planes_im: torch.Tensor,  # (2, N, Kp) int8
    *, k_dim: int, n_dim: int, use_kernel: Optional[bool] = None,
) -> Pair:
    """Prepacked fused complex macro GEMM: one co-located (Re, Im) pack
    serves all four real sub-MACs; only the activations are padded and
    cast per call.  On CUDA, M <= 32 goes to the skinny kernel and any
    other M to the general kernel."""
    M, K = x_re.shape
    if K != k_dim or x_im.shape != (M, K):
        raise ValueError(f"activations {tuple(x_re.shape)}/"
                         f"{tuple(x_im.shape)} vs packed K {k_dim}")
    Kp, Np = weight_layout(k_dim, n_dim)
    for name, t, shape in (("w_re", w_re, (Np, Kp)), ("w_im", w_im, (Np, Kp)),
                           ("planes_re", planes_re, (2, Np, Kp)),
                           ("planes_im", planes_im, (2, Np, Kp))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
    xr, xi = pad_k_int8(x_re, Kp, 1), pad_k_int8(x_im, Kp, 1)
    args = (xr, xi, w_re, planes_re, w_im, planes_im)
    if not resolve_use_kernel(use_kernel, x_re):
        return ccim_complex_prepacked_plain(*args)
    if M <= SKINNY_M:
        return ccim_complex_prepacked_skinny_cuda(*args)
    return ccim_complex_prepacked_general_cuda(*args)


def ccim_complex_matmul(x: torch.Tensor, w: torch.Tensor, *,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Complex float (M, K) @ (K, N) through the fused macro numerics,
    complex64.  Re and Im of each operand share one scale, max-abs over
    both over 127 (they share the array's full scale in silicon); the
    dequantization multiplies by sx * sw formed first, as the reference
    does.  The reference's ``amax / 127.0`` runs under jit, which turns
    the division by a constant into a multiply by its float32 reciprocal;
    so does this."""
    x, w = x.resolve_conj(), w.resolve_conj()
    xr, xi = x.real, x.imag
    wr, wi = w.real, w.imag
    amax_x = torch.clamp_min(torch.maximum(xr.abs(), xi.abs()).amax(
        dim=-1, keepdim=True), 1e-12)
    amax_w = torch.clamp_min(torch.maximum(wr.abs(), wi.abs()).amax(
        dim=0, keepdim=True), 1e-12)
    inv = float(np.float32(1.0) / np.float32(127.0))
    sx, sw = amax_x * inv, amax_w * inv

    def q(v, s):
        return torch.clamp(torch.round(v / s), -127, 127).to(torch.int32)
    y_re, y_im = ccim_complex_matmul_int(q(xr, sx), q(xi, sx), q(wr, sw),
                                         q(wi, sw), use_kernel=use_kernel)
    scale = sx * sw
    return torch.complex(y_re * scale, y_im * scale)
