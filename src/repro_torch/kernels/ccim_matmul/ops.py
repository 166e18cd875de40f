"""Public wrapper of the hybrid-CIM GEMM kernels: the port's weight
layout, activation padding and the M-based dispatch.

Weight layout (the port's own; replaces the TPU's ``pick_weight_blocks``
block padding): w and the folded planes are stored K-contiguous per
output column, ``(N, Kp)`` int8, with K padded only to a multiple of
``max(acc_len, 16)`` -- whole ADC chunks and 16-byte vector loads.  N is
not padded: the kernels mask the ragged edge.  At minicpm-2b's shapes
(K = 2304, 3072, 5760) nothing is padded at all.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .kernel import (SKINNY_M, ccim_matmul_prepacked_general_cuda,
                     ccim_matmul_prepacked_plain,
                     ccim_matmul_prepacked_skinny_cuda)
from .ref import ACC_LEN, DCIM_LSB


def _pad_to(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def weight_layout(K: int, N: int, acc_len: int = ACC_LEN) -> Tuple[int, int]:
    """(Kp, Np): padded K and N of the ``(Np, Kp)`` kernel weight layout.
    Independent of M, so a weight matrix is laid out once at pack time."""
    return _pad_to(K, max(acc_len, 16)), N


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
) -> torch.Tensor:
    """Prepacked-weight macro GEMM -> (M, n_dim) int32 at product scale.

    Only the activations are padded and cast per call.  ``use_kernel``
    None launches a CUDA kernel for CUDA tensors and takes the plain
    version for CPU tensors; False forces the plain version (the plain
    comparison run); True on a CPU tensor raises.  On CUDA, M <= 32 goes
    to the skinny kernel and any other M to the general kernel.
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
    if use_kernel is None:
        use_kernel = x_q.is_cuda
    if use_kernel and not x_q.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors; CPU tensors "
                         "run the plain version (use_kernel=None)")
    meta = dict(acc_len=acc_len, x_bits=tuple(x_bits), dcim_lsb=dcim_lsb,
                adc_half=1 << (adc_bits - 1))
    xp = F.pad(x_q.to(torch.int8), (0, Kp - K)).contiguous()
    if not use_kernel:
        return ccim_matmul_prepacked_plain(xp, w, planes, **meta)
    if M <= SKINNY_M:
        return ccim_matmul_prepacked_skinny_cuda(xp, w, planes, **meta)
    return ccim_matmul_prepacked_general_cuda(xp, w, planes, **meta)
