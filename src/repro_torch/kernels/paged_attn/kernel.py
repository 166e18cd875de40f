"""Hopper CUDA kernels of the paged-attention decode read.

``paged_attention_cuda`` is the port of
``repro/kernels/paged_attn/kernel.py::paged_attention_pallas``: one query
per row against the KV rows its block table names, with a float32
online softmax and P.V with p not rounded to bf16, output rounded to q's
dtype once.  It launches one of two designs by head dim:

- Dh 64 and 128: ``csrc/paged_attn_decode.cu``, a per-warp walk on CUDA
  cores (16-byte loads, each warp its own online softmax, G > 1 in
  blocks of ``GROUP_TILE`` query heads, ``head_groups``);
- Dh 256: ``csrc/paged_attn_dh256.cu``, all G query heads of a kv head
  in one 16-row tensor-core tile (``mma.sync`` bf16 scores, P.V with p
  in two bf16 terms), K and V tiles through a 3-stage ``cp.async`` ring
  in shared memory, and splits that fill the card in one wave
  (``WIDE_BLOCKS_PER_SM``) down to one table entry a split.

Both merge a row's splits in split order in a second kernel.  The
sources are built and loaded by ``kernels/build.py``; the wrapper counts
its calls in ``.launches`` (one a call, whether the call runs the walk
alone or the walk and the combine of its splits).  The plain version is
``ref.py``.

``paged_split`` picks how many splits the kernel cuts each row's walk
into (a rule per design); ``row_walk`` and ``split_ranges`` are the
kernels' arithmetic of which table entries a row attends and which of
them each split walks.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import build, sm_count

MAX_GROUP = 16            # query heads per kv head
HEAD_DIMS = (64, 128, 256)
WIDE_DH = 256             # the head dim of the tensor-core design
GROUP_TILE = 4            # query heads one block takes when G > 1 (Dh < 256)
# split rule: walks of at most SPLIT_MIN_ENTRIES table entries stay whole
# (Dh < 256); longer ones are cut so that the grid has FILL_BLOCKS_PER_SM
# blocks per SM and no split walks more than about SPLIT_MAX_ENTRIES
# entries.  At Dh 256 walks are cut down to one entry a split.
SPLIT_MIN_ENTRIES = 16
SPLIT_MAX_ENTRIES = 64
FILL_BLOCKS_PER_SM = 2
# the Dh 256 walk's blocks resident on an SM (56 KB of shared memory and
# at most 128 registers a thread): its splits fill them in one wave, up to
# WIDE_MAX_SPLITS (the split merge reads that many splits' loads at once;
# more splits measured slower, PERF.md)
WIDE_BLOCKS_PER_SM = 4
WIDE_MAX_SPLITS = 16
H100_SMS = 132

_fns = {}


def _entry(Dh: int):
    """The C entry point of the design for head dim ``Dh``."""
    lib, symbol = (("paged_attn_dh256", "paged_attn_decode_dh256")
                   if Dh == WIDE_DH else ("paged_attn", "paged_attn_decode"))
    if symbol not in _fns:
        fn = getattr(build.library(lib), symbol)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return _fns[symbol]


def _check(q, k_pool, v_pool, table, lengths) -> None:
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("k_pool", k_pool, torch.bfloat16),
                        ("v_pool", v_pool, torch.bfloat16),
                        ("table", table, torch.int32),
                        ("lengths", lengths, torch.int32)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Hq, Dh = q.shape
    Hkv, Dh2 = k_pool.shape[2:]
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v_pool {tuple(v_pool.shape)} != k_pool "
                         f"{tuple(k_pool.shape)}")
    if Dh2 != Dh or Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} (pool {Dh2}): the kernel takes "
                         f"{HEAD_DIMS}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads: the kernel "
                         f"takes groups of at most {MAX_GROUP}")
    if table.dim() != 2 or table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"table {tuple(table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")


def head_groups(G: int) -> int:
    """Blocks per (row, kv head, split) at Dh 64 and 128: one at G 1, else
    one per GROUP_TILE query heads (Dh 256 takes all G in one block)."""
    return 1 if G == 1 else -(-G // GROUP_TILE)


def paged_split(B: int, Hkv: int, G: int, n_entries: int,
                n_sm: int = H100_SMS, Dh: int = 64) -> int:
    """Splits of each row's walk over at most ``n_entries`` table entries
    (the table's width).  Dh 64 and 128: 1 up to SPLIT_MIN_ENTRIES;
    above, enough for FILL_BLOCKS_PER_SM blocks per SM and for at most
    about SPLIT_MAX_ENTRIES entries a split, and never fewer than
    SPLIT_MIN_ENTRIES // 2 entries a split.  Dh 256 (one block per row
    and kv head): as many splits as WIDE_BLOCKS_PER_SM resident blocks per
    SM hold in one wave, at most WIDE_MAX_SPLITS, and at most about
    SPLIT_MAX_ENTRIES entries a split, down to one entry a split."""
    long_walk = -(-n_entries // SPLIT_MAX_ENTRIES)
    if Dh == WIDE_DH:
        fill = min(WIDE_BLOCKS_PER_SM * n_sm // (B * Hkv), WIDE_MAX_SPLITS)
        return max(1, min(max(fill, long_walk), n_entries))
    if n_entries <= SPLIT_MIN_ENTRIES:
        return 1
    fill = -(-FILL_BLOCKS_PER_SM * n_sm // (B * Hkv * head_groups(G)))
    return min(max(fill, long_walk), n_entries // (SPLIT_MIN_ENTRIES // 2))


def row_walk(length: int, bs: int, n_tbl: int, window: Optional[int],
             is_local: bool) -> tuple:
    """(first table entry, entry count) a row of ``length`` attends: from
    the window's first block (or 0) to q_pos's block, within n_tbl."""
    q_pos = length - 1
    local = bool(is_local) and bool(window) and window > 0
    j_lo = max(q_pos - window + 1, 0) // bs if local else 0
    j_hi = 0 if q_pos < 0 else min(q_pos // bs + 1, n_tbl)
    return j_lo, max(j_hi - j_lo, 0)


def split_ranges(j_lo: int, n: int, n_split: int) -> list:
    """[lo, hi) table entries of each split that has work: min(n_split,
    n) of them (at least one), split s from j_lo + s n / splits."""
    n_sb = min(max(n, 1), n_split)
    return [(j_lo + s * n // n_sb, j_lo + (s + 1) * n // n_sb)
            for s in range(n_sb)]


def paged_attention_cuda(
    q: torch.Tensor,              # (B, Hq, Dh) bf16
    k_pool: torch.Tensor,         # (n_blocks, bs, Hkv, Dh) bf16
    v_pool: torch.Tensor,         # (n_blocks, bs, Hkv, Dh) bf16
    table: torch.Tensor,          # (B, n_tbl) int32
    lengths: torch.Tensor,        # (B,) int32, each >= 1
    is_local: bool = False,
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Paged decode attention on the card -> (B, Hq, Dh) bf16.  Block ids
    outside the pool are clamped into it; table entries past
    ceil(lengths[b] / bs) are never read."""
    _check(q, k_pool, v_pool, table, lengths)
    B, Hq, Dh = q.shape
    Hkv = k_pool.shape[2]
    n_split = paged_split(B, Hkv, Hq // Hkv, table.shape[1],
                          sm_count(q.device), Dh)
    out = _launch(q, k_pool, v_pool, table, lengths, is_local, n_split,
                  softcap, window)
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def _launch(q, k_pool, v_pool, table, lengths, is_local, n_split, softcap,
            window) -> torch.Tensor:
    """The kernel at ``n_split`` splits on checked operands (uncounted:
    ``paged_attention_cuda`` counts its calls)."""
    B, Hq, Dh = q.shape
    nb, bs, Hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    ws = (torch.empty(B * Hq * n_split * (Dh + 2), dtype=torch.float32,
                      device=q.device) if n_split > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # the reference's Python-float scale, as the float32 it becomes
    scale = float(np.float32(Dh ** -0.5))
    err = _entry(Dh)(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                   0 if ws is None else ws.data_ptr(), B, Hq, Hkv, Dh, bs,
                   table.shape[1], nb, n_split, scale, float(softcap or 0.0),
                   int(window or 0), int(bool(is_local)), stream)
    if err:
        raise RuntimeError(f"paged_attn_decode launch failed: CUDA error {err}")
    return out


def reset_launch_counts() -> None:
    paged_attention_cuda.launches = 0
