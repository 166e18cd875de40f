"""Hopper CUDA kernels of the hybrid-CIM GEMM, and their plain PyTorch
versions.

Three hand-written kernels (``csrc/``), each the port of one Pallas
kernel of ``repro/kernels/ccim_matmul/kernel.py``:

  ccim_matmul_prepacked_skinny_cuda   M <= 32 (decode); replaces
                                      ccim_matmul_prepacked_skinny_pallas
  ccim_matmul_prepacked_general_cuda  any M (prefill), int8 tensor
                                      cores, K split over the card;
                                      replaces ccim_matmul_prepacked_pallas
  ccim_matmul_unpacked_cuda           raw weights, prototype numerics,
                                      the general kernel's tensor-core
                                      template over a raw-weight tile
                                      fill; replaces ccim_matmul_pallas

The prepacked two take the port's weight layout -- w (N, Kp) and planes
(n_j, N, Kp), int8, K contiguous per output column -- and int8
activations (M, Kp), and return (M, N) int32 at product scale.
``ccim_matmul_prepacked_plain`` computes the same function with float32
batched chunk dots (exact below 2^24); the CPU path and the tests use
it.  The unpacked kernel takes the raw weights as the caller holds them,
(Kp, N) int8, and decomposes them itself; ``ccim_matmul_unpacked_plain``
is its plain version.

The sources are built and loaded by ``kernels/build.py`` (nvcc for
sm_90a at first use, a plain C interface bound through ctypes).  Each
wrapper counts its launches in ``.launches``.

The prepacked kernels and their plain version also count the
conversions whose ADC code clipped (``clips``: one int32 element on the
device, added into; by default the open telemetry collector's
``adc_clip`` buffer, ``obs/taps.py``, and nothing with none open): the
kernels launch their counting instances for it, and the count equals
the plain version's bit for bit.  The TPU kernels count nothing; the
reference counts clips only in its XLA fast path.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from ...core import ccim
from ...obs import taps
from .. import build
from .ref import ACC_LEN, DCIM_LSB

SKINNY_M = 32          # a skinny stage holds <= 32 rows of x (4 token groups)
MAX_PLANES = 3         # distinct activation bits of the widest split (top-6)

_PREPACKED_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 2)
# library name -> (entry point, argtypes)
_ENTRY = {"skinny": ("ccim_prepacked_skinny", _PREPACKED_ARGS),
          "general": ("ccim_prepacked_general", _PREPACKED_ARGS),
          "unpacked": ("ccim_unpacked", [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])}


_fns: Dict[str, object] = {}


def load_kernels() -> Dict[str, object]:
    """Build (if needed) and load the kernel libraries (every kernel of
    the port is built together, ``build.load_all``); returns this
    module's entry points, bound, by name."""
    if not _fns:
        _fns.update(build.bind(_ENTRY))
    return _fns


def skinny_k_split(M: int, N: int, Kp: int, acc_len: int) -> int:
    """Bytes of K (a multiple of 64) that the skinny kernel's largest
    block walks for this shape on the current card: its persistent blocks
    share the (128-column group, 64-byte K stage) sequence evenly, so
    below Kp every column group is cut between blocks."""
    return build.library("skinny").ccim_prepacked_skinny_k_split(
        M, N, Kp, acc_len)


def general_k_split(M: int, N: int, Kp: int, acc_len: int) -> int:
    """Bytes of K per split (a multiple of 64) that the general kernel
    takes for this shape on the current card; it picks the split itself."""
    return build.library("general").ccim_prepacked_general_k_split(
        M, N, Kp, acc_len)


def unpacked_k_split(M: int, N: int, Kp: int) -> int:
    """Bytes of K per split (a multiple of 64) that the unpacked kernel
    takes for this shape on the current card (the general kernel's
    picker at acc_len 16)."""
    return build.library("unpacked").ccim_unpacked_k_split(M, N, Kp)


def _pack_x_bits(x_bits: Sequence[int]) -> int:
    packed = 0
    for i, j in enumerate(x_bits):
        packed |= int(j) << (4 * i)
    return packed


def check_int8_operands(**tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned int8
    CUDA tensor (the kernels load 16 bytes at a time)."""
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != torch.int8:
            raise ValueError(f"{name} must be int8, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check(x: torch.Tensor, w: torch.Tensor, planes: torch.Tensor,
           x_bits: Sequence[int], dcim_lsb: int, acc_len: int) -> None:
    M, Kp = x.shape
    N = w.shape[0]
    check_int8_operands(x=x, w=w, planes=planes)
    if w.shape != (N, Kp):
        raise ValueError(f"w shape {tuple(w.shape)} != ({N}, {Kp})")
    if planes.shape != (len(x_bits), N, Kp):
        raise ValueError(f"planes shape {tuple(planes.shape)} != "
                         f"({len(x_bits)}, {N}, {Kp})")
    if len(x_bits) > MAX_PLANES or len(set(x_bits)) != len(x_bits) or any(
            not 0 <= j < 7 for j in x_bits):
        raise ValueError(f"x_bits {tuple(x_bits)}: at most {MAX_PLANES} "
                         "distinct bit indices in [0, 7)")
    if acc_len not in (8, 16, 32, 64) or Kp % max(acc_len, 16):
        raise ValueError(f"acc_len {acc_len} with Kp {Kp}")
    if dcim_lsb <= 0 or dcim_lsb & (dcim_lsb - 1):
        raise ValueError(f"dcim_lsb {dcim_lsb} is not a power of two")


def _clip_sink(clips: Optional[torch.Tensor], x: torch.Tensor
               ) -> Optional[torch.Tensor]:
    """The clip counter a kernel adds into: ``clips``, or the open
    collector's ``adc_clip`` buffer (None with no collector)."""
    if clips is None:
        clips = taps.sink("adc_clip", x.device)
    if clips is not None and (clips.dtype != torch.int32
                              or clips.numel() != 1
                              or clips.device != x.device):
        raise ValueError("clips must be one int32 element on the device of "
                         f"x, got {clips.dtype} {tuple(clips.shape)} on "
                         f"{clips.device}")
    return clips


def _launch(name: str, x, w, planes, *, acc_len: int, x_bits, dcim_lsb: int,
            adc_half: int, clips: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    _check(x, w, planes, x_bits, dcim_lsb, acc_len)
    clips = _clip_sink(clips, x)
    fn = load_kernels()[name]
    M, Kp = x.shape
    N = w.shape[0]
    if M == 0 or N == 0:
        raise ValueError(f"empty GEMM: M={M}, N={N}")
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), planes.data_ptr() or None,
             out.data_ptr(), M, N, Kp, len(x_bits), _pack_x_bits(x_bits),
             dcim_lsb.bit_length() - 1, adc_half, acc_len,
             None if clips is None else clips.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{_ENTRY[name][0]} launch failed: CUDA error "
                           f"{err}")
    return out


def ccim_matmul_prepacked_skinny_cuda(
    x: torch.Tensor, w: torch.Tensor, planes: torch.Tensor, *,
    acc_len: int = 16, x_bits: Sequence[int] = (6, 5), dcim_lsb: int = 2048,
    adc_half: int = 64, clips: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Skinny-M hybrid-CIM GEMM (M <= 32) -> (M, N) int32; clipped
    conversions added into ``clips`` (module docstring)."""
    if x.shape[0] > SKINNY_M:
        raise ValueError(f"skinny kernel takes M <= {SKINNY_M}, got "
                         f"{x.shape[0]}")
    out = _launch("skinny", x, w, planes, acc_len=acc_len, x_bits=x_bits,
                  dcim_lsb=dcim_lsb, adc_half=adc_half, clips=clips)
    ccim_matmul_prepacked_skinny_cuda.launches += 1
    return out


def ccim_matmul_prepacked_general_cuda(
    x: torch.Tensor, w: torch.Tensor, planes: torch.Tensor, *,
    acc_len: int = 16, x_bits: Sequence[int] = (6, 5), dcim_lsb: int = 2048,
    adc_half: int = 64, clips: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """General-M hybrid-CIM GEMM -> (M, N) int32, on the int8 tensor
    cores; clipped conversions added into ``clips``."""
    out = _launch("general", x, w, planes, acc_len=acc_len, x_bits=x_bits,
                  dcim_lsb=dcim_lsb, adc_half=adc_half, clips=clips)
    ccim_matmul_prepacked_general_cuda.launches += 1
    return out


def ccim_matmul_unpacked_cuda(x: torch.Tensor, w: torch.Tensor
                              ) -> torch.Tensor:
    """Unpacked hybrid-CIM GEMM at the prototype's numerics: x (M, Kp)
    and raw w (Kp, N) int8 -> (M, N) int32 at product scale."""
    check_int8_operands(x=x, w=w)
    M, Kp = x.shape
    N = w.shape[1]
    if w.shape[0] != Kp or Kp % ACC_LEN or M == 0 or N == 0:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}: need "
                         f"(M, Kp) x (Kp, N), Kp a multiple of {ACC_LEN}")
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    err = load_kernels()["unpacked"](
        x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, Kp,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ccim_unpacked launch failed: CUDA error {err}")
    ccim_matmul_unpacked_cuda.launches += 1
    return out


ccim_matmul_prepacked_skinny_cuda.launches = 0
ccim_matmul_prepacked_general_cuda.launches = 0
ccim_matmul_unpacked_cuda.launches = 0


def reset_launch_counts() -> None:
    ccim_matmul_prepacked_skinny_cuda.launches = 0
    ccim_matmul_prepacked_general_cuda.launches = 0
    ccim_matmul_unpacked_cuda.launches = 0


def chunked_operands(w: torch.Tensor, planes: torch.Tensor, acc_len: int,
                     n_chunks: Optional[int] = None):
    """The fast GEMM's chunked operands as views of the int8 kernel
    layout, no copy: w (C, L, N) and one (C, L, N) view per plane.
    ``n_chunks`` keeps the first C chunks (default: all of Kp)."""
    N, Kp = w.shape
    C = n_chunks if n_chunks is not None else Kp // acc_len
    view = lambda v: v[:, :C * acc_len].t().reshape(C, acc_len, N)
    return view(w), tuple(view(p) for p in planes)


def ccim_matmul_prepacked_plain(
    x: torch.Tensor, w: torch.Tensor, planes: torch.Tensor, *,
    acc_len: int = 16, x_bits: Sequence[int] = (6, 5), dcim_lsb: int = 2048,
    adc_half: int = 64, clips: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernels' function in plain PyTorch: x (M, Kp) ints, w (N, Kp)
    and planes (n_j, N, Kp) int8 -> (M, N) int32, bit-identical to the
    kernels, and so is the clip count added into ``clips``.  The float32 operands are cast from int8 views of the
    layout on each call, whole (the cast of a whole view keeps its
    strides, so it streams; nothing float32 is kept beside the pack)."""
    M, Kp = x.shape
    C = Kp // acc_len
    f32 = lambda v: v.to(torch.float32)
    wv, planes_v = chunked_operands(w, planes[:len(x_bits)], acc_len)
    xq = x.to(torch.int32).reshape(M, C, acc_len)
    return ccim.fast_gemm_int(xq, f32(wv), [f32(p) for p in planes_v],
                              tuple(x_bits), dcim_lsb, adc_half,
                              clips=clips) * dcim_lsb


def ccim_matmul_unpacked_plain(x: torch.Tensor, w: torch.Tensor
                               ) -> torch.Tensor:
    """The unpacked kernel's function in plain PyTorch: x (M, Kp) and raw
    w (Kp, N) ints -> (M, N) int32, bit-identical to the kernel and to
    the integer oracle ``ref.ccim_matmul_ref`` (the fast GEMM's float32
    chunk dots are exact)."""
    M, Kp = x.shape
    C = Kp // ACC_LEN
    xq = x.to(torch.int32).reshape(M, C, ACC_LEN)
    wq = w.to(torch.int32).reshape(C, ACC_LEN, w.shape[1])
    return ccim.hybrid_mac_fast_gemm(xq, wq) * DCIM_LSB
