"""Hopper CUDA kernels of the fused complex hybrid-CIM GEMM, and their
plain PyTorch versions.

Three hand-written kernels (``csrc/``), each the port of one Pallas
kernel of ``repro/kernels/ccim_complex/kernel.py``:

  ccim_complex_prepacked_skinny_cuda   M <= 32; replaces
      ccim_complex_matmul_prepacked_skinny_pallas
  ccim_complex_prepacked_general_cuda  any M, int8 tensor cores, K
      split over the card; replaces ccim_complex_matmul_prepacked_pallas
  ccim_complex_unpacked_cuda           raw weights, any M, int8 tensor
      cores, K split over the card; replaces ccim_complex_matmul_pallas

Each returns (y_re, y_im), (M, N) int32 at x 2^11, from int8 activations
x_re, x_im (M, Kp): one residency of the co-located (Re, Im) weights
serves the four real sub-MACs, each clipped per chunk.  The prepacked
kernels read the two packs of a ``PackedComplexCimWeights`` as stored --
w (N, Kp) and planes (2, N, Kp) for each of Re and Im; the unpacked
kernel reads raw (Kp, N) weights and decomposes them itself.  The
prototype's numerics (acc_len 16, top-3 split, 7-bit ADC) are built in.

The plain versions combine four real plain GEMMs as ac - bd and
ad + bc.  The sources are built by ``kernels/build.py``; each wrapper
counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import build
from ..ccim_matmul.kernel import (SKINNY_M, ccim_matmul_prepacked_plain,
                                  ccim_matmul_unpacked_plain,
                                  check_int8_operands)
from ..ccim_matmul.ref import ACC_LEN

Pair = Tuple[torch.Tensor, torch.Tensor]

_P, _I = ctypes.c_void_p, ctypes.c_int
_PREPACKED_ARGS = [_P] * 8 + [_I] * 3 + [_P]
# library name -> (entry point, argtypes)
_ENTRY = {"complex_skinny": ("ccim_complex_skinny", _PREPACKED_ARGS),
          "complex_general": ("ccim_complex_general", _PREPACKED_ARGS),
          "complex_unpacked": ("ccim_complex_unpacked",
                               [_P] * 6 + [_I] * 3 + [_P])}

_fns: Dict[str, object] = {}


def load_kernels() -> Dict[str, object]:
    """Build (if needed) and load every kernel of the port; returns this
    module's entry points, bound, by name."""
    if not _fns:
        _fns.update(build.bind(_ENTRY))
    return _fns


def complex_general_k_split(M: int, N: int, Kp: int) -> int:
    """Bytes of K per split (a multiple of 64) that the general kernel
    takes for this shape on the current card; it picks the split itself."""
    return build.library("complex_general").ccim_complex_general_k_split(
        M, N, Kp)


def complex_unpacked_k_split(M: int, N: int, Kp: int) -> int:
    """Bytes of K per split (a multiple of 64) that the unpacked kernel
    takes for this shape on the current card; it picks the split itself."""
    return build.library("complex_unpacked").ccim_complex_unpacked_k_split(
        M, N, Kp)


def _run(name: str, ptrs, M: int, N: int, Kp: int,
         device: torch.device) -> Pair:
    y_re = torch.empty((M, N), dtype=torch.int32, device=device)
    y_im = torch.empty((M, N), dtype=torch.int32, device=device)
    err = load_kernels()[name](
        *[t.data_ptr() for t in ptrs], y_re.data_ptr(), y_im.data_ptr(),
        M, N, Kp, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{_ENTRY[name][0]} launch failed: CUDA error "
                           f"{err}")
    return y_re, y_im


def _check_x(x_re: torch.Tensor, x_im: torch.Tensor) -> Tuple[int, int]:
    M, Kp = x_re.shape
    if x_im.shape != x_re.shape or Kp % ACC_LEN or M == 0:
        raise ValueError(f"x_re {tuple(x_re.shape)}, x_im "
                         f"{tuple(x_im.shape)}: need equal (M, Kp), M > 0, "
                         f"Kp a multiple of {ACC_LEN}")
    return M, Kp


def _launch_prepacked(name: str, x_re, x_im, w_re, planes_re, w_im,
                      planes_im) -> Pair:
    check_int8_operands(x_re=x_re, x_im=x_im, w_re=w_re, planes_re=planes_re,
                        w_im=w_im, planes_im=planes_im)
    M, Kp = _check_x(x_re, x_im)
    N = w_re.shape[0]
    if (N == 0 or w_re.shape != (N, Kp) or w_im.shape != (N, Kp)
            or planes_re.shape != (2, N, Kp) or planes_im.shape != (2, N, Kp)):
        raise ValueError(f"packs w {tuple(w_re.shape)}/{tuple(w_im.shape)}, "
                         f"planes {tuple(planes_re.shape)}/"
                         f"{tuple(planes_im.shape)}: need (N, {Kp}) and "
                         f"(2, N, {Kp})")
    return _run(name, (x_re, x_im, w_re, planes_re, w_im, planes_im), M, N,
                Kp, x_re.device)


def ccim_complex_prepacked_skinny_cuda(x_re, x_im, w_re, planes_re, w_im,
                                       planes_im) -> Pair:
    """Skinny-M (M <= 32) fused complex GEMM on a prepacked pair."""
    if x_re.shape[0] > SKINNY_M:
        raise ValueError(f"skinny kernel takes M <= {SKINNY_M}, got "
                         f"{x_re.shape[0]}")
    out = _launch_prepacked("complex_skinny", x_re, x_im, w_re, planes_re,
                            w_im, planes_im)
    ccim_complex_prepacked_skinny_cuda.launches += 1
    return out


def ccim_complex_prepacked_general_cuda(x_re, x_im, w_re, planes_re, w_im,
                                        planes_im) -> Pair:
    """General-M fused complex GEMM on a prepacked pair."""
    out = _launch_prepacked("complex_general", x_re, x_im, w_re, planes_re,
                            w_im, planes_im)
    ccim_complex_prepacked_general_cuda.launches += 1
    return out


def ccim_complex_unpacked_cuda(x_re, x_im, w_re, w_im) -> Pair:
    """Fused complex GEMM on raw (Kp, N) int8 weights."""
    check_int8_operands(x_re=x_re, x_im=x_im, w_re=w_re, w_im=w_im)
    M, Kp = _check_x(x_re, x_im)
    N = w_re.shape[1]
    if N == 0 or w_re.shape != (Kp, N) or w_im.shape != (Kp, N):
        raise ValueError(f"w_re {tuple(w_re.shape)}, w_im "
                         f"{tuple(w_im.shape)}: need ({Kp}, N)")
    out = _run("complex_unpacked", (x_re, x_im, w_re, w_im), M, N, Kp,
               x_re.device)
    ccim_complex_unpacked_cuda.launches += 1
    return out


ccim_complex_prepacked_skinny_cuda.launches = 0
ccim_complex_prepacked_general_cuda.launches = 0
ccim_complex_unpacked_cuda.launches = 0


def reset_launch_counts() -> None:
    ccim_complex_prepacked_skinny_cuda.launches = 0
    ccim_complex_prepacked_general_cuda.launches = 0
    ccim_complex_unpacked_cuda.launches = 0


def ccim_complex_prepacked_plain(x_re, x_im, w_re, planes_re, w_im,
                                 planes_im) -> Pair:
    """The prepacked kernels' function in plain PyTorch: four calls of
    the real prepacked plain GEMM, combined as (ac - bd, ad + bc)."""
    mm = ccim_matmul_prepacked_plain
    return (mm(x_re, w_re, planes_re) - mm(x_im, w_im, planes_im),
            mm(x_re, w_im, planes_im) + mm(x_im, w_re, planes_re))


def ccim_complex_unpacked_plain(x_re, x_im, w_re, w_im) -> Pair:
    """The unpacked kernel's function in plain PyTorch: four calls of the
    real unpacked plain GEMM, combined as (ac - bd, ad + bc)."""
    mm = ccim_matmul_unpacked_plain
    return (mm(x_re, w_re) - mm(x_im, w_im), mm(x_re, w_im) + mm(x_im, w_re))
