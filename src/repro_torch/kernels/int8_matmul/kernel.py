"""Hopper CUDA kernel of the W8A8 GEMM, and its plain PyTorch version.

``int8_w8a8_cuda`` (``csrc/int8_w8a8.cu``) replaces
``repro/kernels/int8_matmul/kernel.py::int8_matmul_pallas``: x (M, Kp)
and w (N, Kp) int8, K contiguous, Kp a multiple of ``K_STEP``; sx (M)
and sw (N) float32 -> (M, N) float32 = (float(x @ w^T) * sx[m]) * sw[n],
the int32 accumulator kept inside the kernel.  ``int8_w8a8_plain``
computes the same function in plain PyTorch (``ref.int8_matmul_ref``),
bit for bit.  The library is built with the port's other kernels
(``kernels/build.py``) and bound through ctypes; the wrapper counts its
launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import build
from ..ccim_matmul.kernel import check_int8_operands
from .ref import int8_matmul_ref

K_STEP = 64            # the kernel's K step: the wrapper pads K to it

_ENTRY = {"int8": ("int8_w8a8", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])}
_fns: Dict[str, object] = {}


def load_kernels() -> Dict[str, object]:
    """Build (if needed) and load every kernel library; returns this
    module's entry point, bound."""
    if not _fns:
        _fns.update(build.bind(_ENTRY))
    return _fns


def _check(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
           sw: torch.Tensor) -> None:
    check_int8_operands(x=x, w=w)
    M, Kp = x.shape
    N = w.shape[0]
    if w.shape[1] != Kp or Kp % K_STEP or M == 0 or N == 0:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}: need "
                         f"(M, Kp) and (N, Kp), Kp a multiple of {K_STEP}")
    for name, s, n in (("sx", sx, M), ("sw", sw, N)):
        if (not s.is_cuda or s.dtype != torch.float32 or s.shape != (n,)
                or not s.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({n},) float32 "
                             f"CUDA tensor, got {s.dtype} {tuple(s.shape)}")


def int8_w8a8_cuda(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                   sw: torch.Tensor) -> torch.Tensor:
    """W8A8 GEMM with the fused dequant on the card -> (M, N) float32."""
    _check(x, w, sx, sw)
    M, Kp = x.shape
    N = w.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = load_kernels()["int8"](
        x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        out.data_ptr(), M, N, Kp,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8_w8a8 launch failed: CUDA error {err}")
    int8_w8a8_cuda.launches += 1
    return out


int8_w8a8_cuda.launches = 0


def reset_launch_counts() -> None:
    int8_w8a8_cuda.launches = 0


def int8_w8a8_plain(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                    sw: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the kernel's operands."""
    return int8_matmul_ref(x, w.t(), sx[:, None], sw[None, :])
