"""Hopper CUDA kernels of the prepacked hybrid-CIM GEMM, and their plain
PyTorch version.

Two hand-written kernels (``csrc/``), each the port of one Pallas kernel
of ``repro/kernels/ccim_matmul/kernel.py``:

  ccim_matmul_prepacked_skinny_cuda   M <= 32 (decode); replaces
                                      ccim_matmul_prepacked_skinny_pallas
  ccim_matmul_prepacked_general_cuda  any M (prefill); replaces
                                      ccim_matmul_prepacked_pallas

Both take the port's weight layout -- w (N, Kp) and planes (n_j, N, Kp),
int8, K contiguous per output column -- and int8 activations (M, Kp),
and return (M, N) int32 at product scale.  ``ccim_matmul_prepacked_plain``
computes the same function with float32 batched chunk dots (exact below
2^24); the CPU path and the tests use it.

The sources are compiled with nvcc for sm_90a at first use, one shared
library per source, all started together, into ``build/repro_torch_kernels``
at the repository root, and bound through ctypes (plain C entry points,
no PyTorch headers).  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from ...core import ccim

SKINNY_M = 32          # the skinny kernel's register tile holds <= 32 rows
MAX_PLANES = 3         # distinct activation bits of the widest split (top-6)

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
_SOURCES = {"skinny": "ccim_prepacked_skinny.cu",
            "general": "ccim_prepacked_general.cu"}
_ENTRY = {"skinny": "ccim_prepacked_skinny",
          "general": "ccim_prepacked_general"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    stem = Path(_SOURCES[name]).stem
    return _BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def load_kernels() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; returns them by
    name.  Sources missing from the build directory are compiled in
    parallel, one nvcc per source; a failed build raises with nvcc's
    output.  ``build_info`` records the seconds spent and ptxas's
    register/shared-memory report."""
    if len(_libs) == len(_SOURCES):
        return _libs
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = {}
    for name, src in _SOURCES.items():
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            for _, t, _ in procs.values():
                t.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {_SOURCES[name]} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    build_info.update(seconds=time.time() - t0, built=sorted(procs),
                      ptxas={n: _lib_path(n).with_suffix(".log").read_text()
                             for n in _SOURCES
                             if _lib_path(n).with_suffix(".log").exists()})
    for name in _SOURCES:
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, _ENTRY[name])
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs


def _pack_x_bits(x_bits: Sequence[int]) -> int:
    packed = 0
    for i, j in enumerate(x_bits):
        packed |= int(j) << (4 * i)
    return packed


def _check(x: torch.Tensor, w: torch.Tensor, planes: torch.Tensor,
           x_bits: Sequence[int], dcim_lsb: int, acc_len: int) -> None:
    M, Kp = x.shape
    N = w.shape[0]
    for name, t in (("x", x), ("w", w), ("planes", planes)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != torch.int8:
            raise ValueError(f"{name} must be int8, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
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


def _launch(name: str, x, w, planes, *, acc_len: int, x_bits, dcim_lsb: int,
            adc_half: int) -> torch.Tensor:
    _check(x, w, planes, x_bits, dcim_lsb, acc_len)
    fn = getattr(load_kernels()[name], _ENTRY[name])
    M, Kp = x.shape
    N = w.shape[0]
    if M == 0 or N == 0:
        raise ValueError(f"empty GEMM: M={M}, N={N}")
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), planes.data_ptr() or None,
             out.data_ptr(), M, N, Kp, len(x_bits), _pack_x_bits(x_bits),
             dcim_lsb.bit_length() - 1, adc_half, acc_len, stream)
    if err:
        raise RuntimeError(f"{_ENTRY[name]} launch failed: CUDA error {err}")
    return out


def ccim_matmul_prepacked_skinny_cuda(
    x: torch.Tensor, w: torch.Tensor, planes: torch.Tensor, *,
    acc_len: int = 16, x_bits: Sequence[int] = (6, 5), dcim_lsb: int = 2048,
    adc_half: int = 64,
) -> torch.Tensor:
    """Skinny-M hybrid-CIM GEMM (M <= 32) -> (M, N) int32."""
    if x.shape[0] > SKINNY_M:
        raise ValueError(f"skinny kernel takes M <= {SKINNY_M}, got "
                         f"{x.shape[0]}")
    out = _launch("skinny", x, w, planes, acc_len=acc_len, x_bits=x_bits,
                  dcim_lsb=dcim_lsb, adc_half=adc_half)
    ccim_matmul_prepacked_skinny_cuda.launches += 1
    return out


def ccim_matmul_prepacked_general_cuda(
    x: torch.Tensor, w: torch.Tensor, planes: torch.Tensor, *,
    acc_len: int = 16, x_bits: Sequence[int] = (6, 5), dcim_lsb: int = 2048,
    adc_half: int = 64,
) -> torch.Tensor:
    """General-M hybrid-CIM GEMM -> (M, N) int32."""
    out = _launch("general", x, w, planes, acc_len=acc_len, x_bits=x_bits,
                  dcim_lsb=dcim_lsb, adc_half=adc_half)
    ccim_matmul_prepacked_general_cuda.launches += 1
    return out


ccim_matmul_prepacked_skinny_cuda.launches = 0
ccim_matmul_prepacked_general_cuda.launches = 0


def reset_launch_counts() -> None:
    ccim_matmul_prepacked_skinny_cuda.launches = 0
    ccim_matmul_prepacked_general_cuda.launches = 0


def chunked_operands(w: torch.Tensor, planes: torch.Tensor, acc_len: int,
                     n_chunks: Optional[int] = None):
    """float32 chunked operands of the fast GEMM, derived from the int8
    kernel layout: wf (C, L, N) and the planes concatenated along L,
    (C, J*L, N) -- the reference pack's ``gemm_w``/``gemm_planes``.
    ``n_chunks`` keeps the first C chunks (default: all of Kp)."""
    N, Kp = w.shape
    C = n_chunks if n_chunks is not None else Kp // acc_len
    K = C * acc_len
    chunk = lambda v: v[:, :K].t().reshape(C, acc_len, N).to(torch.float32)
    wf = chunk(w)
    w_pl = (torch.cat([chunk(p) for p in planes], dim=1) if planes.shape[0]
            else torch.zeros((C, 0, N), dtype=torch.float32, device=w.device))
    return wf, w_pl


def ccim_matmul_prepacked_plain(
    x: torch.Tensor, w: torch.Tensor, planes: torch.Tensor, *,
    acc_len: int = 16, x_bits: Sequence[int] = (6, 5), dcim_lsb: int = 2048,
    adc_half: int = 64,
) -> torch.Tensor:
    """The kernels' function in plain PyTorch: x (M, Kp) ints, w (N, Kp)
    and planes (n_j, N, Kp) int8 -> (M, N) int32, bit-identical to the
    kernels.  The float32 operands are derived from the int8 layout on
    each call (nothing float32 is kept beside the pack)."""
    M, Kp = x.shape
    C = Kp // acc_len
    wf, w_pl = chunked_operands(w, planes[:len(x_bits)], acc_len)
    xq = x.to(torch.int32).reshape(M, C, acc_len)
    return ccim.fast_gemm_int(xq, wf, w_pl, tuple(x_bits), dcim_lsb,
                              adc_half) * dcim_lsb
