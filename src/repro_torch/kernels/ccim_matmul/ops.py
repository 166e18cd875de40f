"""Public wrappers of the hybrid-CIM GEMM kernels: the port's weight
layout, activation padding and the M-based dispatch of the prepacked
kernels, and the unpacked GEMM on raw weights.

Weight layout (the port's own; replaces the TPU's ``pick_weight_blocks``
block padding): w and the folded planes are stored K-contiguous per
output column, ``(N, Kp)`` int8, with K padded only to a multiple of
``max(acc_len, 16)`` -- whole ADC chunks and 16-byte vector loads.  N is
not padded: the kernels mask the ragged edge.  At minicpm-2b's shapes
(K = 2304, 3072, 5760) nothing is padded at all.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...obs import taps
from .kernel import (SKINNY_M, ccim_matmul_prepacked_general_cuda,
                     ccim_matmul_prepacked_plain,
                     ccim_matmul_prepacked_skinny_cuda,
                     ccim_matmul_unpacked_cuda, ccim_matmul_unpacked_plain)
from .ref import ACC_LEN, DCIM_LSB


def _pad_to(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def weight_layout(K: int, N: int, acc_len: int = ACC_LEN) -> Tuple[int, int]:
    """(Kp, Np): padded K and N of the ``(Np, Kp)`` kernel weight layout,
    K padded to whole chunks and 16-byte rows (``max(acc_len, 16)`` for
    the kernels' power-of-two chunks; the chunked fast GEMM's views of
    a pack need whole chunks at any other acc_len too).  Independent of
    M, so a weight matrix is laid out once at pack time."""
    return _pad_to(K, math.lcm(acc_len, 16)), N


def resolve_use_kernel(use_kernel: Optional[bool], x: torch.Tensor) -> bool:
    """None: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor.  True on a CPU tensor raises."""
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors; CPU tensors "
                         "run the plain version (use_kernel=None)")
    return use_kernel


def pad_k_int8(v: torch.Tensor, kp: int, dim: int) -> torch.Tensor:
    """``v`` cast to int8 with axis ``dim`` (0 or 1) zero-padded to
    ``kp``, contiguous: the one copy a raw operand gets per call."""
    pad = kp - v.shape[dim]
    v = v.to(torch.int8)
    return F.pad(v, (0, pad) if dim == 1 else (0, 0, 0, pad)).contiguous()


def ccim_matmul_int_prepacked(
    x_q: torch.Tensor,        # (M, K) ints in [-127, 127]
    w: torch.Tensor,          # (Np, Kp) int8, laid out at pack time
    planes: torch.Tensor,     # (len(x_bits), Np, Kp) int8 folded planes
    *,
    k_dim: int, n_dim: int,
    acc_len: int = ACC_LEN,
    x_bits: Sequence[int] = (6, 5),
    dcim_lsb: int = DCIM_LSB,
    adc_bits: int = 7,
    use_kernel: Optional[bool] = None,
    clips: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Prepacked-weight macro GEMM -> (M, n_dim) int32 at product scale.

    Only the activations are padded and cast per call.  ``use_kernel``
    None launches a CUDA kernel for CUDA tensors and takes the plain
    version for CPU tensors; False forces the plain version (the plain
    comparison run); True on a CPU tensor raises.  On CUDA, M <= 32 goes
    to the skinny kernel and any other M to the general kernel.
    ``clips`` (one int32 element on the device; by default the open
    telemetry collector's ``adc_clip`` buffer) gets the count of
    clipped conversions, from the kernel or the plain version alike.
    """
    M, K = x_q.shape
    if K != k_dim:
        raise ValueError(f"activation K {K} != packed K {k_dim}")
    Kp, Np = weight_layout(k_dim, n_dim, acc_len)
    if tuple(w.shape) != (Np, Kp):
        raise ValueError(f"weight layout {tuple(w.shape)} != {(Np, Kp)}")
    if tuple(planes.shape) != (len(x_bits), Np, Kp):
        raise ValueError(f"planes {tuple(planes.shape)} != "
                         f"{(len(x_bits), Np, Kp)}")
    use_kernel = resolve_use_kernel(use_kernel, x_q)
    meta = dict(acc_len=acc_len, x_bits=tuple(x_bits), dcim_lsb=dcim_lsb,
                adc_half=1 << (adc_bits - 1), clips=clips)
    xp = pad_k_int8(x_q, Kp, 1)
    if not use_kernel:
        return ccim_matmul_prepacked_plain(xp, w, planes, **meta)
    if M <= SKINNY_M:
        return ccim_matmul_prepacked_skinny_cuda(xp, w, planes, **meta)
    return ccim_matmul_prepacked_general_cuda(xp, w, planes, **meta)


def ccim_matmul_int(x_q: torch.Tensor, w_q: torch.Tensor, *,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """(M, K) x (K, N) ints in [-127, 127] -> (M, N) int32 macro GEMM at
    the prototype's numerics (scale 2^11), on raw weights: K is padded to
    whole chunks and both operands cast to int8 once; the kernel
    decomposes the weights itself.  ``use_kernel`` as in
    ``ccim_matmul_int_prepacked``."""
    Kp = _pad_to(x_q.shape[1], ACC_LEN)
    if w_q.shape[0] != x_q.shape[1]:
        raise ValueError(f"x {tuple(x_q.shape)} @ w {tuple(w_q.shape)}")
    xp, wp = pad_k_int8(x_q, Kp, 1), pad_k_int8(w_q, Kp, 0)
    if resolve_use_kernel(use_kernel, x_q):
        if taps.active():
            # row 6 counts no clips: a telemetry run would read a false 0
            raise NotImplementedError(
                "the unpacked kernel counts no ADC clips; serve packed "
                "weights (or the plain version) with telemetry on")
        return ccim_matmul_unpacked_cuda(xp, wp)
    return ccim_matmul_unpacked_plain(xp, wp)
