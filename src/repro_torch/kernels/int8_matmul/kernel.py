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

The kernel is a TMA-fed ``wgmma`` pipeline (see the ``.cu``): a block
owns ``BN`` weight rows, ``tok`` tokens and one K slice; the slices of
one output tile form a thread-block cluster that sums its int32 partial
tiles in shared memory.  ``plan`` picks the token width, the K split and
the ring depth from (M, N, Kp) and the SM count, and the wrapper passes
it to the entry point, so the CPU tests hold the plan itself.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import torch

from .. import build, sm_count
from ..ccim_matmul.kernel import check_int8_operands
from .ref import int8_matmul_ref

K_STEP = 64            # the kernel's K step: the wrapper pads K to it
BN = 128               # weight rows a block: two consumer warpgroups of 64
K_STAGE = 128          # K bytes a ring stage: one 128-byte swizzle row
TOKS = (8, 16, 32, 64, 128)   # token widths (wgmma N) the kernel is built at
MAX_SPLITS = 8         # K slices of one tile: the portable cluster size
SPLIT_CAP = 4          # K slices the plan takes beyond one block an SM: 6
                       # and 8 timed slower cold (each slice adds a partial
                       # tile to the cluster's exchange)
FEW_TILES_TOK = 64     # token width when weight tiles are few (see plan)
BLOCKS_PER_SM = 2      # registers <= 112 and shared memory <= ~110 KB a block
RING_BYTES = 111488    # a block's ring: 2 blocks, their barriers and the
                       # 1 KB alignment slack each fit the SM's 228 KB
MAX_RING = 6
STAGING_PITCH = BN + 4  # int32 row pitch of the partial tile parked in
                        # the ring's memory after the main loop

_ENTRY = {"int8": ("int8_w8a8", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])}
_fns: Dict[str, object] = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's tiling: a grid of (splits, m_tiles, n_tiles) blocks,
    the ``splits`` blocks of one output tile a cluster; block s sums K
    stages [s * per_split, min(k_stages, (s + 1) * per_split)) of 128
    bytes (the last stage of an odd number of 64-byte steps is half
    zeros); ``ring`` stages of (BN + tok) x 128 bytes in flight."""
    tok: int
    m_tiles: int
    n_tiles: int
    k_stages: int
    splits: int
    per_split: int
    ring: int

    @property
    def blocks(self) -> int:
        return self.splits * self.m_tiles * self.n_tiles

    def k_ranges(self, kp: int):
        """The K byte range [lo, hi) of each split, clipped to ``kp``."""
        step = self.per_split * K_STAGE
        return [(s * step, min(kp, (s + 1) * step))
                for s in range(self.splits)]


def plan(M: int, N: int, Kp: int, sms: int) -> Plan:
    """The tiling of an (M, Kp) x (N, Kp) W8A8 GEMM on a card of ``sms``
    SMs.  Tokens: the narrowest width of ``TOKS`` that holds M, tiles of
    128 over the grid above that (the tiles of one weight tile are
    neighbours in launch order, so their weight reads meet in L2); but
    tiles of ``FEW_TILES_TOK`` when the weight tiles number under a
    quarter of the SMs, so that K is split with half the partial tile to
    exchange (faster cold at minicpm-2b's N 2,304 shapes at M 128 in
    chip_smoke.py phase 21's sweep; PERF.md section 6).  K: enough slices
    (at most ``MAX_SPLITS``) to put a block on every SM, and beyond that
    as many (at most ``SPLIT_CAP``) as leave every block resident at
    once, two an SM; then evened out so that no slice is empty.  Ring: as
    many stages (at most ``MAX_RING``) as fit ``RING_BYTES``."""
    n_tiles = -(-N // BN)
    tok = next((t for t in TOKS if t >= M), TOKS[-1])
    if tok > FEW_TILES_TOK and 4 * n_tiles < sms:
        tok = FEW_TILES_TOK
    m_tiles = -(-M // tok)
    k_stages = -(-Kp // K_STAGE)
    tiles = m_tiles * n_tiles
    splits = max(min(MAX_SPLITS, -(-sms // tiles)),
                 min(SPLIT_CAP, sms * BLOCKS_PER_SM // tiles))
    splits = max(1, min(splits, k_stages))
    per_split = -(-k_stages // splits)
    splits = -(-k_stages // per_split)
    ring = min(MAX_RING, RING_BYTES // ((BN + tok) * K_STAGE))
    return Plan(tok, m_tiles, n_tiles, k_stages, splits, per_split, ring)


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


def _launch(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
            sw: torch.Tensor, p: Plan) -> torch.Tensor:
    """The kernel under plan ``p`` on checked operands (uncounted: the
    wrapper counts, and design sweeps call this with other plans)."""
    M, Kp = x.shape
    N = w.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = load_kernels()["int8"](
        x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        out.data_ptr(), M, N, Kp, p.tok, p.splits, p.per_split, p.ring,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8_w8a8 launch failed: CUDA error {err}")
    return out


def int8_w8a8_cuda(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                   sw: torch.Tensor) -> torch.Tensor:
    """W8A8 GEMM with the fused dequant on the card -> (M, N) float32."""
    _check(x, w, sx, sw)
    M, Kp = x.shape
    out = _launch(x, w, sx, sw, plan(M, w.shape[0], Kp, sm_count(x.device)))
    int8_w8a8_cuda.launches += 1
    return out


int8_w8a8_cuda.launches = 0


def reset_launch_counts() -> None:
    int8_w8a8_cuda.launches = 0


def int8_w8a8_plain(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                    sw: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the kernel's operands."""
    return int8_matmul_ref(x, w.t(), sx[:, None], sw[None, :])
