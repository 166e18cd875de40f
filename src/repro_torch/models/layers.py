"""Model-zoo building blocks of the dense, moe and ssm families: RMSNorm,
RoPE, GQA attention (blocked flash forward and plain), SwiGLU MLP, the
MoE layer (routed top-k experts with a shared expert) and the Mamba2
(SSD) mixer.

Counterpart of ``repro/models/layers.py``.  Every projection routes
through ``_dense`` -> ``core.engine.CimEngine``, so packed weights
(``lm.pack_cim_params``) run on the emulated C-CIM macro; fused packed
groups (QKV, gate/up, the mamba2 input projections) run as one wide
macro GEMM each.  Functions are
plain torch on tensors; ``*_init`` take an explicit ``torch.Generator``.
"""
from __future__ import annotations

import contextlib
import functools
import math
import pathlib
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import prng
from ..core.ccim import DEFAULT_CONFIG
from ..core.engine import CimEngine, FusedPackedCimWeights, PackedCimWeights
from ..kernels.paged_attn import ops as paged_attn_ops
from ..kernels.paged_attn import ref as paged_attn_ref
from .config import ModelConfig

Params = Dict[str, Any]

_NEG = -1e30          # masked score (the reference's constant)
_FAR = 10 ** 9        # k position of a padded / unwritten key
_TINY_F32 = float(np.finfo(np.float32).tiny)


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------


def cim_engine(cfg: ModelConfig, path: Optional[str] = None) -> CimEngine:
    """The execution engine a model config resolves to (macro config,
    fidelity and kernel routing all come from the config).  With a
    deployment plan (``cfg.cim_plan``) the projection ``path`` (e.g.
    "attn/wq") resolves to its own entry's macro config and fidelity."""
    if cfg.cim_plan is not None and path is not None:
        e = cfg.cim_plan.resolve(path)
        return CimEngine(cfg=e.cfg, fidelity=e.fidelity,
                         use_kernel=cfg.cim_use_kernel)
    return CimEngine(cfg=cfg.cim_cfg or DEFAULT_CONFIG,
                     fidelity=cfg.cim_fidelity,
                     use_kernel=cfg.cim_use_kernel)


@functools.lru_cache(maxsize=64)
def _noise_key(seed: int, path: str, device: torch.device) -> torch.Tensor:
    key = prng.fold_in(prng.PRNGKey(seed),
                       zlib.crc32(path.encode("utf-8")))
    return key.to(device)


def _dense_noise_key(cfg: ModelConfig, path: Optional[str],
                     device) -> Optional[torch.Tensor]:
    """The projection's analog-noise stream under ``cfg.cim_noise_seed``
    (None without one): the seed folded with the crc32 of the path, so
    every projection draws its own noise, reproducibly.  The layers of a
    stack share a path, and so one draw pattern, as the macro's banks are
    reused for every layer.  Cached per (seed, path, device), so a
    captured step reads a key that already sits on the device; the
    graph holds the keys it read (``hold_tables``)."""
    if cfg.cim_noise_seed is None:
        return None
    args = (cfg.cim_noise_seed, path or "", torch.device(device))
    key = _noise_key(*args)
    for held in _HOLDERS:
        held[("noise_key",) + args] = key
    return key


def _dense(x: torch.Tensor, w, cfg: ModelConfig,
           path: Optional[str] = None) -> torch.Tensor:
    """x (..., K) @ w (K, N); packed weights run on the macro, and so do
    raw float weights under ``cfg.cim_mode`` (quantized per call), with
    the path's analog noise under ``cfg.cim_noise_seed``.  ``path`` names
    the projection for the deployment plan and its noise stream; a
    plan's ``float`` fidelity bypasses the macro."""
    if isinstance(w, PackedCimWeights):
        if not cfg.cim_mode:
            raise ValueError(
                "packed CIM weights require cim_mode=True (packed params "
                "are macro array contents, not float matrices)")
        eng = cim_engine(cfg, path)
        if eng.fidelity == "float":
            raise ValueError(
                f"plan assigns fidelity 'float' to {path!r} but its weights "
                "are packed macro array contents; re-pack under the plan "
                "(lm.pack_cim_params leaves float-fidelity sites unpacked)")
        return eng.matmul(x, w, _dense_noise_key(cfg, path, x.device))
    if cfg.cim_mode:
        eng = cim_engine(cfg, path)
        if eng.fidelity == "float":
            return matmul(x, w)
        return eng.matmul(x, w, _dense_noise_key(cfg, path, x.device))
    return matmul(x, w)


# rows of every bf16 GEMM on the card: the rows are cut into tiles of
# this many (the last zero-padded), so each GEMM call has one shape
_ROW_TILE = 64


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype with float32 accumulation and one rounding.

    On the CPU the product runs as a float32 GEMM and is rounded once:
    that reproduces the reference's bf16 dots bit for bit, where the
    CPU's own bf16 GEMM sums in another order and flips a few bf16
    results.  On CUDA the bf16 GEMM accumulates in float32 already, and
    the rows go through in ``_ROW_TILE``-row GEMMs of one shape: cuBLAS
    picks its algorithm (tiles, split-K) by M, so a row's sum order
    would otherwise depend on how many rows came with it, and a verify
    forward over k+1 positions must give each position the decode
    step's logits bit for bit."""
    if not x.is_cuda:
        return (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)
    lead, k = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, k)
    r = rows.shape[0]
    rows = F.pad(rows, (0, 0, 0, -r % _ROW_TILE))
    out = torch.cat([rows[i:i + _ROW_TILE] @ w
                     for i in range(0, rows.shape[0], _ROW_TILE)])
    return out[:r].reshape(*lead, w.shape[-1])


def _tree_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed pairwise order: the axis is
    zero-padded to a power of two and halved (first half + second half)
    until one element is left.  Each step sums an axis of two, which is
    a + b whatever the reduction's layout, so a row's sum does not depend
    on how many rows there are; and trailing zeros do not change it
    (x + 0 == x), so neither does the padded length -- a cache of another
    length gives the same sums."""
    n = t.shape[-1]
    t = F.pad(t, (0, (1 << max(n - 1, 0).bit_length()) - n))
    while t.shape[-1] > 1:
        t = t.unflatten(-1, (2, t.shape[-1] // 2)).sum(dim=-2)
    return t[..., 0]


FUSED_SEP = "+"   # fused param-leaf key: member names joined, e.g. "wq+wk+wv"


def fusion_partitions(cfg: ModelConfig, prefix: str, names) -> list:
    """Partition fusion-candidate projections (which share one input
    activation) by resolved plan entry: [(entry cfg, fidelity, members)]
    for every partition of two or more.  The one definition of group
    compatibility: pack time (``lm._pack_tree``) and run time
    (``_dense_group``) must agree.  Only 'fast' and 'exact' fuse; a
    'float' site bypasses the macro.  Without a deployment plan every
    member resolves to the config's one engine."""
    part: Dict[Tuple, list] = {}
    for n in names:
        eng = cim_engine(cfg, prefix + n)
        if eng.fidelity in ("fast", "exact"):
            part.setdefault((eng.cfg, eng.fidelity), []).append(n)
    return [(c, f, g) for (c, f), g in part.items() if len(g) >= 2]


def _split_segments(y: torch.Tensor, names, dims) -> Dict[str, torch.Tensor]:
    """Split a fused (..., sum(dims)) output into per-projection results."""
    offs = np.cumsum((0,) + tuple(dims))
    return {n: y[..., int(offs[i]):int(offs[i + 1])]
            for i, n in enumerate(names)}


def _seg_noise(cfg: ModelConfig, prefix: str, names, device
               ) -> Optional[Tuple[torch.Tensor, ...]]:
    """Per-segment noise keys of a fused group: each segment draws the
    stream its unfused projection would, which keeps fusion bit-identical
    under analog noise."""
    if cfg.cim_noise_seed is None:
        return None
    return tuple(_dense_noise_key(cfg, prefix + n, device) for n in names)


def _dense_fused(x: torch.Tensor, leaf: FusedPackedCimWeights,
                 cfg: ModelConfig, prefix: str, names
                 ) -> Dict[str, torch.Tensor]:
    """One activation quantization + one wide macro GEMM, split per
    segment (each segment with its own noise stream)."""
    if not cfg.cim_mode:
        raise ValueError(
            "fused packed CIM weights require cim_mode=True (packed params "
            "are macro array contents, not float matrices)")
    y = cim_engine(cfg, prefix + names[0]).matmul(
        x, leaf, _seg_noise(cfg, prefix, names, x.device))
    return _split_segments(y, names, leaf.seg_dims)


def _dense_group(x: torch.Tensor, p: Params, names, cfg: ModelConfig,
                 prefix: str) -> Dict[str, torch.Tensor]:
    """Run a block's projections that all consume ``x``, each result
    bit-identical to ``_dense``'s: pack-time fused leaves (key
    "wq+wk+wv") as one GEMM each; under ``cfg.cim_mode`` and
    ``cfg.cim_fuse``, raw weights that resolve to one plan entry
    concatenated along N for the call (unpacked serving runs the same
    few wide GEMMs a packed one does, each segment with its own noise
    stream); the rest per projection."""
    remaining = list(names)
    out: Dict[str, torch.Tensor] = {}
    for key, leaf in p.items():
        if isinstance(leaf, FusedPackedCimWeights):
            segs = key.split(FUSED_SEP)
            if all(s in remaining for s in segs):
                out.update(_dense_fused(x, leaf, cfg, prefix, segs))
                remaining = [n for n in remaining if n not in segs]
    if cfg.cim_mode and cfg.cim_fuse and len(remaining) > 1:
        fusable = [n for n in remaining
                   if isinstance(p.get(n), torch.Tensor)]
        for ecfg, fid, g in fusion_partitions(cfg, prefix, fusable):
            eng = CimEngine(cfg=ecfg, fidelity=fid,
                            use_kernel=cfg.cim_use_kernel)
            wcat = torch.cat([p[n] for n in g], dim=-1)
            dims = tuple(int(p[n].shape[-1]) for n in g)
            nkeys = _seg_noise(cfg, prefix, g, x.device)
            y = eng.matmul(x, wcat, nkeys,
                           noise_segments=dims if nkeys else None)
            out.update(_split_segments(y, g, dims))
            remaining = [n for n in remaining if n not in g]
    for n in remaining:
        out[n] = _dense(x, p[n], cfg, prefix + n)
    return out


def _init_dense(gen: torch.Generator, shape, dtype, scale=None):
    """Normal(0, 1/d_in) weights of ``shape`` (..., d_in, d_out)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    # scaled in place: a stacked leaf's float32 draw is the init's peak
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device).mul_(scale)
    return w.to(dtype)


_WINDOW = 32     # the reference's CPU tree-reduction window


def _window_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the reference's compiled CPU order: XLA
    rewrites a reduction longer than 32 into 32-wide windows, each summed
    in order, with the axis zero-padded evenly at both ends to whole
    windows; the window sums are reduced the same way until at most 32
    remain, which are summed in order."""
    while t.shape[-1] > _WINDOW:
        pad = -t.shape[-1] % _WINDOW
        t = F.pad(t, (pad // 2, pad - pad // 2))
        t = t.reshape(*t.shape[:-1], -1, _WINDOW)
        acc = t[..., 0]
        for i in range(1, _WINDOW):
            acc = acc + t[..., i]
        t = acc
    acc = t[..., 0]
    for i in range(1, t.shape[-1]):
        acc = acc + t[..., i]
    return acc


# XLA-CPU's float32 rsqrt minus the correctly rounded one, in float32 bit
# steps, at every (exponent parity, mantissa): ``tools/rsqrt_table.py``
_RSQRT_TABLE = pathlib.Path(__file__).with_name("rsqrt_xla_cpu.bin")


@functools.lru_cache(maxsize=1)
def avx512f_host() -> bool:
    """Whether this CPU has AVX-512 (torch's capability, which asks for
    AVX-512F among others): the host on which XLA-CPU's rsqrt was
    measured (``xla_rsqrt``)."""
    probe = getattr(torch.cpu, "_is_avx512_supported", None)
    return bool(probe is not None and probe())


@functools.lru_cache(maxsize=1)
def _rsqrt_fix() -> torch.Tensor:
    """(2^24,) int8 corrections of ``_RSQRT_TABLE``: 2 bits an entry
    (0: none, 1: +1, 2: -1), four a byte, zlib-compressed."""
    raw = np.frombuffer(zlib.decompress(_RSQRT_TABLE.read_bytes()), np.uint8)
    code = (raw[:, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3
    fix = (code == 1).astype(np.int8) - (code == 2).astype(np.int8)
    return torch.from_numpy(fix.reshape(-1))


@prng.analytic_grad(lambda g, x, y: g * (-0.5 * (y / x)))
def xla_rsqrt(v: torch.Tensor) -> torch.Tensor:
    """rsqrt of float32 ``v`` on the CPU as the reference's compiled code
    takes it.  XLA-CPU's rsqrt is the processor's estimate and a Newton
    step: one float32 ulp off the correctly rounded value on 13.05 % of
    inputs, and invariant under scaling by 4, so a table over (exponent
    parity, 23 mantissa bits) holds it whole (``tools/rsqrt_table.py``
    swept all 2^24 inputs of [1, 4)).  On an AVX-512 host, where it was
    measured, the correctly rounded rsqrt is moved by the table's step at
    every normal input; elsewhere it stays correctly rounded (no other
    host's estimate was measured).  Its gradient is jax's rule for rsqrt,
    -0.5 * rsqrt(v) / v (the table has no gradient of its own)."""
    r = (1.0 / torch.sqrt(v.to(torch.float64))).to(torch.float32)
    if not avx512f_host():
        return r
    bits = v.view(torch.int32)
    idx = ((((bits >> 23) & 1) ^ 1) << 23) | (bits & 0x7FFFFF)
    normal = (bits >= 0x00800000) & (bits < 0x7F800000)
    step = torch.where(normal, _rsqrt_fix()[idx.long()], 0)
    return (r.view(torch.int32) + step).view(torch.float32)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + w) in float32, rounded to x's dtype.

    On the CPU the mean reproduces the reference bit for bit: the sum of
    squares in its window order (``_window_sum``), times the float32
    reciprocal of the width as XLA folds the division, and XLA-CPU's
    rsqrt (``xla_rsqrt``; torch's ``rsqrt`` differs more often).  On CUDA
    the sum of squares is ``_tree_sum``'s:
    torch's fused mean picks its reduction layout by the number of rows,
    and on float32 inputs (the unrounded residual sum) a row's mean then
    depends on how many rows came with it (``tools/row_probe.py``), where
    a verify forward must give each row the decode step's norm."""
    dt = x.dtype
    x = x.to(torch.float32)
    if x.is_cuda:
        r = torch.rsqrt(_tree_sum(x * x)[..., None] / x.shape[-1] + eps)
    else:
        inv_d = float(np.float32(1.0) / np.float32(x.shape[-1]))
        ms = _window_sum(x * x)[..., None] * inv_d
        r = xla_rsqrt(ms + eps)
    x = x * r
    return (x * (1.0 + w.to(torch.float32))).to(dt)


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def round_grad(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` unchanged, its cotangent rounded to ``dtype``.  Where the
    port feeds a float32 value unrounded to keep the reference's compiled
    forward (XLA fuses a convert away), the reference's graph holds a
    ``dtype`` value there, and its cotangent is rounded at that point."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _RoundGrad.apply(x, dtype)
    return x


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """cap * tanh(x / cap) on float32 ``x``.  On the CPU as the
    reference's compiled code runs it: the division folded into a
    multiply by the float32 reciprocal, and XLA's tanh (``prng.tanh``;
    torch's differs on more than half of the float32 inputs)."""
    if cap is None:
        return x
    if x.is_cuda:
        return cap * torch.tanh(x / cap)
    return cap * prng.tanh(x * float(np.float32(1.0) / np.float32(cap)))


def _libm():
    import ctypes
    import ctypes.util
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("sinf", "cosf"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return lib


@functools.lru_cache(maxsize=16)
def _rope_table(n_pos: int, half: int, theta: float, device: str):
    """(cos, sin) float32 tables of shape (n_pos, half) for positions
    0..n_pos-1.  Bit-identical to the reference's on-the-fly angles:
    the frequencies are 1/theta^(i/half) correctly rounded to float32,
    the angles a float32 product, and the reference's CPU lowering
    evaluates sin/cos with the C library's sinf/cosf, as this does."""
    e = np.arange(half, dtype=np.float32) / np.float32(half)
    freqs = (1.0 / np.float64(theta) ** e.astype(np.float64)).astype(
        np.float32)
    ang = np.arange(n_pos, dtype=np.float32)[:, None] * freqs[None, :]
    lib = _libm()
    cos = np.array([lib.cosf(float(a)) for a in ang.ravel()], np.float32)
    sin = np.array([lib.sinf(float(a)) for a in ang.ravel()], np.float32)
    return (torch.from_numpy(cos.reshape(ang.shape)).to(device),
            torch.from_numpy(sin.reshape(ang.shape)).to(device))


_HOLDERS: list = []        # the dicts of the open ``hold_tables`` blocks


@contextlib.contextmanager
def hold_tables():
    """Yields a dict that receives every cached table ``rope`` reads and
    every cached noise key ``_dense_noise_key`` hands out inside the
    block.  A captured graph (``launch/graphs.py``) keeps it: its replays
    read the tensors' memory, which the bounded caches alone would free
    on eviction."""
    held: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
    _HOLDERS.append(held)
    try:
        yield held
    finally:
        _HOLDERS.remove(held)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         n_pos: int) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) in [0, n_pos) -> x with each
    (i, i + D/2) pair rotated by pos / theta^(2i/D)."""
    half = x.shape[-1] // 2
    key = (n_pos, half, float(theta), str(x.device))
    cos_t, sin_t = tables = _rope_table(*key)
    for held in _HOLDERS:
        held[key] = tables
    cos, sin = cos_t[positions][:, :, None, :], sin_t[positions][:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    # the reference's compiled rope contracts each rotation into one fused
    # multiply-add, a * cos -/+ round(b * sin) rounded once; float64
    # holds a * cos exactly, so one float64 op and a rounding match it
    f64 = lambda t: t.to(torch.float64)
    o1 = f64(x1) * f64(cos) - f64(x2 * sin)
    o2 = f64(x2) * f64(cos) + f64(x1 * sin)
    return torch.cat([o1, o2], dim=-1).to(torch.float32).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------


def _head_mask(cfg: ModelConfig, device) -> Optional[torch.Tensor]:
    """(padded_heads,) 1/0 mask; None when no padding is in effect."""
    if cfg.padded_heads == cfg.n_heads:
        return None
    return (torch.arange(cfg.padded_heads, device=device)
            < cfg.n_heads).to(torch.float32)


def _lead(n_layers: Optional[int]) -> tuple:
    """The stacked layer axis, or none for one unstacked block."""
    return () if n_layers is None else (n_layers,)


def attention_init(gen: torch.Generator, cfg: ModelConfig,
                   n_layers: Optional[int], dtype) -> Params:
    """Stacked (n_layers, ...) projections with TP-padded head counts; pad
    head slots are zero and masked after attention.  ``n_layers=None``
    gives one unstacked block (2-D leaves: the hybrid's shared block)."""
    dh, d, n = cfg.head_dim, cfg.d_model, _lead(n_layers)
    hq, hkv = cfg.padded_heads, cfg.padded_kv_heads
    p = {"wq": _init_dense(gen, (*n, d, hq * dh), dtype),
         "wk": _init_dense(gen, (*n, d, hkv * dh), dtype),
         "wv": _init_dense(gen, (*n, d, hkv * dh), dtype),
         "wo": _init_dense(gen, (*n, hq * dh, d), dtype)}
    mask = _head_mask(cfg, gen.device)
    if mask is not None:
        mq = torch.repeat_interleave(mask, dh)[None, :].to(dtype)
        p["wq"] = p["wq"] * mq
        p["wo"] = p["wo"] * mq.T
        if hkv == hq:  # MHA: kv heads padded alongside q heads
            p["wk"] = p["wk"] * mq
            p["wv"] = p["wv"] * mq
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((*n, dh), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((*n, dh), dtype=dtype, device=gen.device)
    return p


def _qkv(p, x, cfg: ModelConfig, positions, n_pos: int, path="attn"):
    B, S, _ = x.shape
    dh = cfg.head_dim
    hq, hkv = cfg.padded_heads, cfg.padded_kv_heads
    qkv = _dense_group(x, p, ("wq", "wk", "wv"), cfg, f"{path}/")
    q = qkv["wq"].reshape(B, S, hq, dh)
    k = qkv["wk"].reshape(B, S, hkv, dh)
    v = qkv["wv"].reshape(B, S, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta, n_pos)
    k = rope(k, positions, cfg.rope_theta, n_pos)
    return q, k, v


def _mask(q_pos, k_pos, is_local: bool, window, n_prefix):
    """(B, Sq, Sk) boolean mask."""
    causal = q_pos[:, :, None] >= k_pos[:, None, :]
    if n_prefix:
        causal = causal | (k_pos[:, None, :] < n_prefix)
    if window is not None and is_local:
        causal = causal & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    return causal


def _scale_q(qg: torch.Tensor) -> torch.Tensor:
    """qg * Dh^-0.5 in qg's dtype, as float32.  The scale is rounded to
    qg's dtype first, as the reference's weakly typed Python scalar is
    (torch would multiply by the unrounded scalar)."""
    scale = float(torch.tensor(qg.shape[-1] ** -0.5, dtype=qg.dtype))
    return (qg * scale).to(torch.float32)


def _flash_blocks(k, v, k_pos, blk):
    B, Sk, Hkv, Dh = k.shape
    n_blk = (Sk + blk - 1) // blk
    pad = n_blk * blk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=_FAR)
    kb = k.reshape(B, n_blk, blk, Hkv, Dh).transpose(0, 1)
    vb = v.reshape(B, n_blk, blk, Hkv, Dh).transpose(0, 1)
    pb = k_pos.reshape(B, n_blk, blk).transpose(0, 1)
    return kb, vb, pb, pad


def _flash_fwd(cfg, n_prefix, q, k, v, q_pos, k_pos, is_local,
               orders=None):
    """Forward over KV blocks in order with an f32 online softmax;
    returns (out (B, Hkv, G, Sq, Dh) f32, m, l).  On the CPU the score
    and P.V dots sum in ``orders`` (``_ordered_sum``'s names; default
    ``flash_orders`` at this call's shapes)."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    blk = min(cfg.flash_block, k.shape[1])
    s_order, pv_order = orders or flash_orders(G * Sq, Dh, blk)
    kb, vb, pb, _ = _flash_blocks(k, v, k_pos, blk)
    qg = _scale_q(q.reshape(B, Sq, Hkv, G, Dh))
    m = torch.full((B, Hkv, G, Sq), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, Dh), dtype=torch.float32,
                      device=q.device)
    cpu = not q.is_cuda
    for kc, vc, pc in zip(kb, vb, pb):
        s = _lane_scores(qg, kc.to(torch.float32), s_order)
        s = softcap(s, cfg.attn_softcap)
        msk = _mask(q_pos, pc, is_local, cfg.sliding_window, n_prefix)
        s = torch.where(msk[:, None, None, :, :], s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        if cpu:
            # the reference's compiled step: XLA's exp, its windowed sum,
            # the two multiply-adds fused and its P.V dot's order
            p = prng.exp(s - m_new[..., None])
            corr = prng.exp(m - m_new)
            l = prng.fma(l, corr, _window_sum(p))
        else:
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
        pb = p.to(vc.dtype).to(torch.float32)
        if cpu and pv_order != "torch":
            prod = (pb[..., None, :]
                    * vc.to(torch.float32).permute(0, 2, 3, 1)[:, :, None,
                                                               None])
            pv = _ordered_sum(prod, pv_order)
        else:
            pv = torch.einsum("bhgqk,bkhd->bhgqd", pb, vc.to(torch.float32))
        acc = (prng.fma(acc, corr[..., None], pv) if cpu
               else acc * corr[..., None] + pv)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out, m, l


def _flash_bwd(cfg, n_prefix, q, k, v, q_pos, k_pos, is_local, out, m, l,
               dy):
    """The reference's block-recomputing flash backward: p is rebuilt
    block by block from the saved (m, l), so memory stays O(S) in the KV
    length.  As in the reference, q is scaled in float32 here (the
    forward scales it in its own dtype) and the scores are recomputed in
    the forward's sum order (``_lane_scores``); the four dots of a block
    are float32 einsums."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    blk = min(cfg.flash_block, Sk)
    s_order, _ = flash_orders(G * Sq, Dh, blk)
    kb, vb, pb, pad = _flash_blocks(k, v, k_pos, blk)
    scale = float(np.float32(Dh ** -0.5))
    qg = q.reshape(B, Sq, Hkv, G, Dh).to(torch.float32) * scale
    dyg = dy.reshape(B, Sq, Hkv, G, Dh).permute(0, 2, 3, 1, 4).to(
        torch.float32)                                     # (B,Hkv,G,Sq,Dh)
    l_safe = torch.clamp_min(l, 1e-30)
    drow = (dyg * out).sum(dim=-1)                         # (B,Hkv,G,Sq)
    exp = torch.exp if q.is_cuda else prng.exp
    dq = torch.zeros((B, Sq, Hkv, G, Dh), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for kc, vc, pc in zip(kb, vb, pb):
        kf, vf = kc.to(torch.float32), vc.to(torch.float32)
        z = softcap(_lane_scores(qg, kf, s_order), cfg.attn_softcap)
        msk = _mask(q_pos, pc, is_local, cfg.sliding_window,
                    n_prefix)[:, None, None]
        z = torch.where(msk, z, _NEG)
        p = exp(z - m[..., None]) / l_safe[..., None]      # (B,Hkv,G,Sq,blk)
        dvs.append(torch.einsum("bhgqk,bhgqd->bkhd", p, dyg))
        dp = torch.einsum("bhgqd,bkhd->bhgqk", dyg, vf)
        dz = p * (dp - drow[..., None])
        if cfg.attn_softcap is not None:
            # masked BEFORE the tanh' factor: a masked z of -1e30 would
            # give 0 * inf = NaN
            factor = 1.0 - (z / cfg.attn_softcap) ** 2
            dz = dz * torch.where(msk, factor, 0.0)
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", dz, kf)
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", dz, qg))
    dq = (dq * scale).reshape(B, Sq, Hq, Dh).to(q.dtype)
    dk = torch.cat(dks, dim=1)[:, :Sk].to(k.dtype)
    dv = torch.cat(dvs, dim=1)[:, :Sk].to(v.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with the reference's custom VJP: the forward
    keeps (q, k, v, out, m, l), not the blocks' probabilities."""

    @staticmethod
    def forward(ctx, cfg, n_prefix, q, k, v, q_pos, k_pos, is_local):
        out, m, l = _flash_fwd(cfg, n_prefix, q, k, v, q_pos, k_pos,
                               is_local)
        ctx.cfg, ctx.n_prefix, ctx.is_local = cfg, n_prefix, is_local
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, m, l)
        B, Sq, Hq, Dh = q.shape
        return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)

    @staticmethod
    def backward(ctx, dy):
        q, k, v, q_pos, k_pos, out, m, l = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(ctx.cfg, ctx.n_prefix, q, k, v, q_pos, k_pos,
                                ctx.is_local, out, m, l, dy)
        return None, None, dq, dk, dv, None, None, None


def flash_attention(cfg: ModelConfig, n_prefix, q, k, v, q_pos, k_pos,
                    is_local) -> torch.Tensor:
    """Blocked attention, O(S) memory in the KV length, forward and
    backward (``_FlashAttention`` where autograd records)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(cfg, n_prefix, q, k, v, q_pos, k_pos,
                                     is_local)
    B, Sq, Hq, Dh = q.shape
    out, _, _ = _flash_fwd(cfg, n_prefix, q, k, v, q_pos, k_pos, is_local)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)


_LANES = 8


def _lane_scores(qg: torch.Tensor, k: torch.Tensor,
                 order: str = "lanes") -> torch.Tensor:
    """Scores (B, Hkv, G, Sq, Sk) of qg (B, Sq, Hkv, G, D) against
    k (B, Sk, Hkv, D), both float32, summed over D in the order the
    reference's compiled CPU dot takes at the caller's shapes.  Products
    of bf16 values are exact in float32, so only the order of the sums
    can differ; matching it keeps each score bit-identical, and a score
    one ulp off can flip a bf16 probability and then a macro ADC code
    downstream.  Orders are ``_ordered_sum``'s (XLA-CPU picks one by the
    dot's shapes and the host's bf16 instructions; ``decode_order`` and
    ``flash_orders`` name the measured ones).  On CUDA always the 8
    lanes: the pair-wise sum over D is D / 2 kernels a read, and the
    card's contract is only that a score does not depend on how many
    rows come with it."""
    prod = (qg.permute(0, 2, 3, 1, 4)[:, :, :, :, None, :]
            * k.permute(0, 2, 1, 3)[:, :, None, None, :, :])
    return _ordered_sum(prod, "lanes" if prod.is_cuda else order)


_BLOCK = 32      # the contraction block of XLA-CPU's two-lane bf16 dot


def _ordered_sum(prod: torch.Tensor, order: str) -> torch.Tensor:
    """Sum of exact float32 products over the last axis, in one of the
    orders XLA-CPU's bf16 dots take: "lanes", 8 interleaved lanes (k = l,
    l + 8, ...) each summed in order, then a pairwise tree across the
    lanes; "pairs", the pair-wise bf16 dot (VDPBF16PS: acc += p[2i+1],
    then acc += p[2i]; an odd last product added alone); "blocks", per
    32-element block of the axis two lanes (even and odd k) each summed
    in order and then added, the blocks' sums added in order.  Other
    axis lengths than the order takes sum in torch's order."""
    K = prod.shape[-1]
    if order == "pairs" and K > 1:
        acc = prod[..., 1] + prod[..., 0]
        for i in range(2, K - 1, 2):
            acc = acc + prod[..., i + 1]
            acc = acc + prod[..., i]
        return acc + prod[..., K - 1] if K % 2 else acc
    if order == "blocks" and K % _BLOCK == 0:
        prod = prod.unflatten(-1, (K // _BLOCK, _BLOCK // 2, 2))
        acc = None
        for b in range(K // _BLOCK):
            lane = prod[..., b, 0, :]
            for i in range(1, _BLOCK // 2):
                lane = lane + prod[..., b, i, :]
            blk = lane[..., 0] + lane[..., 1]
            acc = blk if acc is None else acc + blk
        return acc
    if order != "lanes" or K % _LANES:
        return prod.sum(dim=-1)
    prod = prod.reshape(*prod.shape[:-1], K // _LANES, _LANES)
    acc = prod[..., 0, :]
    for i in range(1, K // _LANES):
        acc = acc + prod[..., i, :]
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    return acc[..., 0]


@functools.lru_cache(maxsize=1)
def bf16_dot_host() -> bool:
    """Whether this CPU has AVX512-BF16 (VDPBF16PS, the pair-wise bf16
    dot), the host on which ``decode_order``'s orders were measured."""
    probe = getattr(torch.cpu, "_is_avx512_bf16_supported", None)
    return bool(probe is not None and probe())


def decode_order(G: int) -> str:
    """The score dot's order (``_lane_scores``) of a one-query decode
    read with G query heads a kv head: under GQA on an AVX512-BF16 host
    the pair-wise bf16 dot, as measured against the reference's jitted
    reads there; 8 lanes otherwise (XLA-CPU's choice on another host was
    not measured; ROADMAP Queue 3 item 8 lists the prefill dots' orders,
    which the port does not reproduce)."""
    return "pairs" if G > 1 and bf16_dot_host() else "lanes"


# XLA-CPU's order for the flash prefill's two bf16 dots on an AVX512-BF16
# host, by the dot's shape: ("s", M, Dh, blk) the scores (M = G * Sq
# query rows a kv head, contracting the head dim against a block of
# keys) and ("pv", M, blk, Dh) P.V (contracting the block's keys).  The
# dots listed take the two-lane 32-element blocks, every other the
# pair-wise bf16 dot: measured against the jitted reference's flash at
# every shape the port's CPU tests reach (``tools/flash_dot_probe.py``,
# which holds each measured shape to this rule; the order does not
# depend on G or Sq apart from their product).
FLASH_BLOCK_DOTS = frozenset({
    ("s", 24, 32, 32), ("s", 32, 32, 64), ("s", 48, 32, 12),
    ("s", 64, 32, 18), ("s", 64, 32, 37), ("s", 64, 32, 48),
    ("s", 80, 32, 24), ("s", 96, 32, 24), ("s", 96, 32, 32),
    ("s", 128, 32, 64), ("s", 160, 32, 64), ("s", 288, 32, 64),
    ("pv", 16, 64, 32), ("pv", 32, 64, 32), ("pv", 128, 64, 32),
    ("pv", 160, 64, 32)})


def flash_orders(M: int, Dh: int, blk: int) -> Tuple[str, str]:
    """(score order, P.V order) of the flash prefill's dots with M query
    rows a kv head, head dim Dh and key blocks of blk (``_ordered_sum``'s
    names): ``FLASH_BLOCK_DOTS`` on an AVX512-BF16 host, else the port's
    8 lanes and torch's order (XLA-CPU's choice on another host was not
    measured)."""
    if not bf16_dot_host():
        return "lanes", "torch"
    pick = lambda dot: "blocks" if dot in FLASH_BLOCK_DOTS else "pairs"
    return pick(("s", M, Dh, blk)), pick(("pv", M, blk, Dh))


# XLA-CPU's float32 sum order of the lm_head on an AVX512-BF16 host: the
# reference's bf16 head dot runs as a float32 dot of the converted
# operands, rounded once to bf16, and the order of its sums depends on
# the rows M, the contraction K, the vocabulary N and whether the head is
# the tied ``embed.T``.  Measured in ``_logits`` by
# ``tools/lm_head_dot_probe.py`` at every (K, N) listed, M 1 to 256.  Two
# rows or more run a GEMM: an untied head of up to ``_HALVES_MAX_M`` rows
# sums each half of K in order and adds the halves, every other head all
# of K in order.  One row is a loop that LLVM vectorizes over K in 8-lane
# chunks (chunk j holds k in [8j, 8j + 8)): the untied head's loop (the
# final norm fused into it) keeps four 8-lane sums, sum i taking chunks
# i, i + 4, ..., adds them in order and halves the lanes (4 + 4, 2 + 2,
# 1 + 1); the tied head's loop (a transposed copy of the embedding fused
# in) is unrolled whole and adds the chunks into one 8-lane sum in
# ``_GEMV_CHUNKS``' order, then halves the lanes.
LM_HEAD_SHAPES = frozenset({(128, 512)})
_HALVES_MAX_M = 50
_GEMV_CHUNKS = (0, 4, 8, 12, 5, 1, 9, 13, 6, 2, 10, 14, 7, 3, 11, 15)


def lm_head_order(M: int, K: int, N: int, tied: bool) -> str:
    """The lm_head's sum order on the CPU (``head_sums``' names) for M
    rows: measured at a listed shape on an AVX512-BF16 host, else torch's
    own GEMM ("torch"; XLA-CPU's choice there was not measured)."""
    if not bf16_dot_host() or (K, N) not in LM_HEAD_SHAPES:
        return "torch"
    if M == 1:
        return "gemv" if tied else "vec"
    return "halves" if not tied and M <= _HALVES_MAX_M else "seq"


def _halve_lanes(acc: torch.Tensor) -> torch.Tensor:
    while acc.shape[-1] > 1:
        acc = acc[..., :acc.shape[-1] // 2] + acc[..., acc.shape[-1] // 2:]
    return acc[..., 0]


def head_sums(xf: torch.Tensor, wf: torch.Tensor, order: str
              ) -> torch.Tensor:
    """xf (M, K) @ wf (K, N), both float32 holding bf16 values, with the
    exact products summed over K in ``order``: "seq" sums k = 0, 1, ...
    in order; "halves" sums each half of K so and adds the two; "vec"
    and "gemv" are the one-row loops' orders over 8-lane chunks (see
    ``LM_HEAD_SHAPES``); "torch" is torch's float32 GEMM."""
    K = xf.shape[-1]
    if order == "torch":
        return xf @ wf
    if order in ("vec", "gemv"):
        q = (xf[:, None, :] * wf.T[None]).unflatten(-1, (K // 8, 8))
        if order == "gemv":
            acc = q[..., _GEMV_CHUNKS[0], :]
            for j in _GEMV_CHUNKS[1:]:
                acc = acc + q[..., j, :]
            return _halve_lanes(acc)
        q = q.unflatten(-2, (K // 32, 4))       # (M, N, K/32, 4, 8)
        acc = q[..., 0, :, :]
        for i in range(1, K // 32):
            acc = acc + q[..., i, :, :]
        lanes = acc[..., 0, :]
        for j in range(1, 4):
            lanes = lanes + acc[..., j, :]
        return _halve_lanes(lanes)
    blk = K // 2 if order == "halves" else K
    out = None
    for lo in range(0, K, blk):
        acc = xf[:, lo, None] * wf[lo]
        for k in range(lo + 1, lo + blk):
            acc = acc + xf[:, k, None] * wf[k]
        out = acc if out is None else out + acc
    return out


def head_matmul(x: torch.Tensor, w: torch.Tensor, order: str
                ) -> torch.Tensor:
    """x (..., K) @ w (K, N) in x's dtype: on the CPU ``head_sums`` in
    ``order``, rounded once; on CUDA ``matmul``."""
    if order == "torch" or x.is_cuda:
        return matmul(x, w)
    lead, K = x.shape[:-1], x.shape[-1]
    out = head_sums(x.reshape(-1, K).to(torch.float32), w.to(torch.float32),
                    order)
    return out.to(x.dtype).reshape(*lead, w.shape[-1])


def plain_attention(q, k, v, q_pos, k_pos, cfg: ModelConfig, is_local,
                    n_prefix=0) -> torch.Tensor:
    """Masked softmax attention, materialized.  On CUDA the softmax sum
    and P.V sum over the keys in ``_tree_sum``'s order (elementwise
    products, no GEMM): a library reduction or batched GEMM picks its
    order by its shapes, and a query must get the same bits whether it
    comes alone (a decode step) or with k others (a verify forward), and
    whatever the cache's length (lock-step and speculative serving size
    their caches differently)."""
    B, Sq, Hq, Dh = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = _scale_q(q.reshape(B, Sq, Hkv, G, Dh))
    s = _lane_scores(qg, k.to(torch.float32),
                     decode_order(G) if Sq == 1 else "lanes")
    s = softcap(s, cfg.attn_softcap)
    msk = _mask(q_pos, k_pos, is_local, cfg.sliding_window, n_prefix)
    s = torch.where(msk[:, None, None, :, :], s, _NEG)
    s = s - s.amax(dim=-1, keepdim=True)
    if q.is_cuda:
        e = torch.exp(s)
        p = e / _tree_sum(e)[..., None]
        vt = v.to(torch.float32).permute(0, 2, 3, 1)[:, :, None, None]
        pv = p.to(v.dtype).to(torch.float32)[..., None, :] * vt
        out = _tree_sum(pv).permute(0, 3, 1, 2, 4).to(v.dtype)
        return out.reshape(B, Sq, Hq, Dh)
    # jax.nn.softmax as the reference's compiled CPU code runs it: XLA's
    # exp and its windowed sum (torch's exp differs on about a sixth of
    # float32 inputs, and its sum order from the windows')
    e = prng.exp(s)
    p = e / _window_sum(e)[..., None]
    out = decode_pv(p.to(v.dtype).to(torch.float32), v.to(torch.float32),
                    decode_order(G) if Sq == 1 else "lanes")
    return out.to(v.dtype).reshape(B, Sq, Hq, Dh)


def decode_pv(p: torch.Tensor, v: torch.Tensor, order: str) -> torch.Tensor:
    """P.V on the CPU: p (B, Hkv, G, Sq, Sk) and v (B, Sk, Hkv, D), both
    float32 holding bf16 values -> (B, Sq, Hkv, G, D) float32, summed over
    the keys in the reference's order at a one-query read
    (``decode_order``): the pair-wise bf16 dot under GQA, torch's own
    order otherwise (the order XLA-CPU takes there is not reproduced)."""
    if order != "pairs":
        return torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    prod = (p[..., None, :]
            * v.permute(0, 2, 3, 1)[:, :, None, None])
    return _ordered_sum(prod, order).permute(0, 3, 1, 2, 4)


def attention_apply(
    p: Params,
    x: torch.Tensor,                # (B, S, D)
    cfg: ModelConfig,
    positions: torch.Tensor,        # (B, S)
    is_local: bool,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_pos: Optional[torch.Tensor] = None,    # (B,) per-row write index
    path: str = "attn",
    block_table: Optional[torch.Tensor] = None,  # (B, n_tbl) int32: paged
    write_mask: Optional[torch.Tensor] = None,   # (B,) bool: rows that write
    n_prefix: int = 0,              # keys below it seen by every query
):
    """Returns (out (B, S, D), new_kv or None).  Every query sees the keys
    at positions below ``n_prefix`` (the vlm's prefix-LM mask: its
    frontend tokens attend to each other both ways); the others causally.

    With a contiguous ``kv_cache`` ((B, Smax, Hkv, Dh) each) row b writes
    its S new entries at ``cache_pos[b]`` IN PLACE (the reference returns
    updated copies; writing in place saves a cache copy per layer) and
    attends over its first ``cache_pos[b] + S`` entries.

    With ``block_table`` the cache is PAGED: ``kv_cache`` holds global
    ``(n_blocks, block_size, Hkv, Dh)`` pools shared by every row, and row
    b's logical position p lives at pool[table[b, p // bs], p % bs].  The
    new entries are written in place through the table (rows masked out
    by ``write_mask`` go to the trash block 0: the pools are shared, so a
    frozen slot must not write into blocks another request reads).  S == 1
    reads go to the paged-attention kernel (``kernels/paged_attn``) with
    ``lengths = cache_pos + 1``; S > 1 (prefill chunks) gathers the table
    into a dense view and runs the same masked attention as the
    contiguous path."""
    B, S, _ = x.shape
    if kv_cache is None:
        n_pos = S
    elif block_table is not None:
        n_pos = block_table.shape[1] * kv_cache[0].shape[1]
    else:
        n_pos = kv_cache[0].shape[1]
    q, k, v = _qkv(p, x, cfg, positions, n_pos, path)
    new_kv = None
    if kv_cache is not None and block_table is not None:
        ck, cv = kv_cache
        nb, bs, hkv, dh = ck.shape
        n_tbl = block_table.shape[1]
        pos_w = cache_pos[:, None] + torch.arange(S, device=x.device)[None, :]
        blk = torch.gather(block_table, 1,
                           torch.clamp(pos_w // bs, max=n_tbl - 1).long())
        if write_mask is not None:
            blk = torch.where(write_mask[:, None], blk, 0)   # trash block
        flat = (blk.long() * bs + pos_w % bs).reshape(-1)
        ck.view(nb * bs, hkv, dh).index_copy_(
            0, flat, k.to(ck.dtype).reshape(B * S, hkv, dh))
        cv.view(nb * bs, hkv, dh).index_copy_(
            0, flat, v.to(cv.dtype).reshape(B * S, hkv, dh))
        new_kv = (ck, cv)
        if S == 1:
            out = paged_attn_ops.paged_attention_decode(
                q[:, 0], ck, cv, block_table, cache_pos + 1, is_local,
                softcap=cfg.attn_softcap, window=cfg.sliding_window,
                use_kernel=cfg.paged_attn_use_kernel)[:, None]
            return _attn_out(p, out, cfg, B, S, path), new_kv
        k_full = paged_attn_ref.paged_gather_kv(ck, block_table)
        v_full = paged_attn_ref.paged_gather_kv(cv, block_table)
        L = k_full.shape[1]
        k_pos = torch.arange(L, device=x.device)[None, :].expand(B, L)
        valid = k_pos < (cache_pos[:, None] + S)
        k_pos = torch.where(valid, k_pos, _FAR)
    elif kv_cache is not None:
        ck, cv = kv_cache
        rows = torch.arange(B, device=x.device)[:, None]
        idx = cache_pos[:, None] + torch.arange(S, device=x.device)[None, :]
        ck[rows, idx] = k.to(ck.dtype)
        cv[rows, idx] = v.to(cv.dtype)
        new_kv = (ck, cv)
        k_pos = torch.arange(ck.shape[1], device=x.device)[None, :].expand(
            B, ck.shape[1])
        valid = k_pos < (cache_pos[:, None] + S)
        k_pos = torch.where(valid, k_pos, _FAR)
        k_full, v_full = ck, cv
    else:
        k_pos = positions
        k_full, v_full = k, v

    if cfg.attn_impl == "flash" and S > 1:
        out = flash_attention(cfg, n_prefix, q, k_full, v_full, positions,
                              k_pos, is_local)
    else:
        out = plain_attention(q, k_full, v_full, positions, k_pos, cfg,
                              is_local, n_prefix)
    return _attn_out(p, out, cfg, B, S, path), new_kv


def _attn_out(p: Params, out: torch.Tensor, cfg: ModelConfig, B: int, S: int,
              path: str) -> torch.Tensor:
    """Attention epilogue: TP-pad head masking + wo projection."""
    mask = _head_mask(cfg, out.device)
    if mask is not None:
        out = out * mask[None, None, :, None].to(out.dtype)
    return _dense(out.reshape(B, S, -1), p["wo"], cfg, f"{path}/wo")


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             n_layers: Optional[int], dtype,
             d_ff: Optional[int] = None) -> Params:
    """Stacked (n_layers, ...) SwiGLU weights; ``n_layers=None`` gives one
    unstacked block."""
    d_ff, n = d_ff or cfg.d_ff, _lead(n_layers)
    return {"w1": _init_dense(gen, (*n, cfg.d_model, d_ff), dtype),
            "w3": _init_dense(gen, (*n, cfg.d_model, d_ff), dtype),
            "w2": _init_dense(gen, (*n, d_ff, cfg.d_model), dtype)}


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the reference's rounding: sigmoid expands to
    1 / (1 + exp(-x)) and every op rounds to x's dtype (bf16).
    ``F.silu`` rounds once, which flips about a third of the bf16
    results -- and a flipped activation can flip a macro ADC code.  A
    float32 ``x`` on the CPU takes XLA's exp (``prng.exp``)."""
    return x * _sigmoid(x)


@prng.analytic_grad(lambda g, x, y: g * (y * (1.0 - y)))
def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` (``lax.logistic``) as XLA expands it, every op
    in x's dtype; its gradient is jax's rule g * (y * (1 - y))."""
    f32_cpu = x.dtype == torch.float32 and not x.is_cuda
    return 1.0 / (1.0 + (prng.exp(-x) if f32_cpu else torch.exp(-x)))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form) with the reference's rounding on
    the CPU: x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))))
    with every op rounded to x's dtype (bf16), the constants rounded to
    it first, XLA's float32 tanh (``prng.tanh``) and a subnormal product
    flushed to zero.  Equal to the jitted reference on all 65,536 bf16
    inputs; ``F.gelu`` rounds once and differs on 1,518 of them.  On
    CUDA it is ``F.gelu``: one kernel a call."""
    if x.is_cuda:
        return F.gelu(x, approximate="tanh")
    rnd = lambda c: float(torch.tensor(c, dtype=x.dtype))
    inner = x + (x * x) * x * rnd(0.044715)
    t = prng.tanh((inner * rnd(math.sqrt(2.0 / math.pi))).to(
        torch.float32)).to(x.dtype)
    y = x.to(torch.float32) * ((1.0 + t) * 0.5).to(torch.float32)
    return torch.where(y.abs() < _TINY_F32, 0.0, y).to(x.dtype)


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              path: str = "mlp") -> torch.Tensor:
    gu = _dense_group(x, p, ("w1", "w3"), cfg, f"{path}/")
    if cfg.act == "silu":
        h = _silu(gu["w1"]) * gu["w3"]
    else:
        h = _gelu(gu["w1"]) * gu["w3"]
    return _dense(h, p["w2"], cfg, f"{path}/w2")


# ---------------------------------------------------------------------------
# MoE: shared expert + routed top-k with capacity (scatter dispatch)
# ---------------------------------------------------------------------------
# The routed experts are bf16 matrix products outside the macro (the
# reference's einsums reach no Pallas kernel); the shared expert is an
# MLP under the plan path "moe/shared" and runs on the macro.  On the
# card every operation a token's output passes through is row-local with
# a result that does not depend on how many tokens come with it: the
# router's float32 GEMM and the expert GEMMs go through in 64-row tiles
# of one shape (``matmul``, ``_expert_matmul``), the softmax sums with
# ``_tree_sum`` and the gate and k sums run in a fixed order.


def moe_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
             dtype) -> Params:
    """Stacked (n_layers, ...) MoE params: the float32 router (D, E), the
    experts' w1 and w3 (E, D, F) and w2 (E, F, D) in ``dtype`` at the
    reference's scales (1/sqrt(D), 1/sqrt(F)), and the shared expert (a
    SwiGLU MLP of ``shared_expert_d_ff``) where the config has one.  Each
    expert stack is allocated once and drawn a layer at a time: the
    float32 draw of a whole stack never exists (qwen2-moe-a2.7b's w1
    stack alone is 16.6 GB in float32)."""
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": _init_dense(gen, (n_layers, D, E), torch.float32)}
    for name, shape, fan_in in (("w1", (E, D, F_), D), ("w3", (E, D, F_), D),
                                ("w2", (E, F_, D), F_)):
        stack = torch.empty((n_layers, *shape), dtype=dtype,
                            device=gen.device)
        for i in range(n_layers):
            stack[i] = _init_dense(gen, shape, dtype, 1.0 / math.sqrt(fan_in))
        p[name] = stack
    if cfg.shared_expert_d_ff:
        p["shared"] = mlp_init(gen, cfg, n_layers, dtype,
                               cfg.shared_expert_d_ff)
    return p


def _expert_matmul(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """buf (..., E, C, K) @ w (E, K, N) -> (..., E, C, N) in buf's dtype,
    float32 accumulation and one rounding.  On the CPU each expert's
    product is a float32 GEMM rounded once (as ``matmul``).  On CUDA the
    rows of every expert go through in ``_ROW_TILE``-row batched GEMMs of
    one shape, so a token's result does not depend on the buffer's
    capacity (the number of tokens routed with it)."""
    lead, (E, C, K) = buf.shape[:-3], buf.shape[-3:]
    x = buf.reshape(-1, E, C, K).transpose(0, 1).reshape(E, -1, K)
    if not buf.is_cuda:
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(
            buf.dtype)
    else:
        r = x.shape[1]
        x = F.pad(x, (0, 0, 0, -r % _ROW_TILE))
        y = torch.cat([torch.bmm(x[:, i:i + _ROW_TILE], w)
                       for i in range(0, x.shape[1], _ROW_TILE)], dim=1)[:, :r]
    N = w.shape[-1]
    return y.reshape(E, -1, C, N).transpose(0, 1).reshape(*lead, E, C, N)


def _moe_ffn(p: Params, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Per-expert SwiGLU over a dispatched buffer (..., E, C, D)."""
    act = _silu if cfg.act == "silu" else _gelu
    h = act(_expert_matmul(buf, p["w1"])) * _expert_matmul(buf, p["w3"])
    return _expert_matmul(h, p["w2"])


def _gated_sum(yk: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """(T, K, D) expert outputs, (T, K) float32 gates -> (T, D): the sum
    over k of each output times its gate, as the reference's compiled
    code takes it.  In bf16 each product is rounded to bf16 and the
    products are summed in float32 in order and rounded once; in float32
    the products and the sum contract into multiply-adds in order (on
    the CPU rounded once each, ``prng.fma``)."""
    g = gates.to(yk.dtype)[..., None]
    if yk.dtype == torch.float32:
        acc = yk[:, 0] * g[:, 0]
        for k in range(1, yk.shape[1]):
            acc = _fma(yk[:, k], g[:, k].expand_as(acc), acc)
        return acc
    prod = (yk * g).to(torch.float32)
    acc = prod[:, 0]
    for k in range(1, yk.shape[1]):
        acc = acc + prod[:, k]
    return acc.to(yk.dtype)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 one-hot of ``idx`` over n classes (a comparison: no range
    check, which on CUDA would read the indices back to the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def _moe_small(p, xf, eidx, gates, cfg):
    """Exact (no-drop) path for small token counts: capacity T * K."""
    T, D = xf.shape
    E, K = cfg.n_experts, cfg.top_k
    ef = eidx.reshape(T * K)
    oh = _one_hot(ef, E)
    myp = (torch.cumsum(oh, dim=0) - oh).gather(1, ef[:, None])[:, 0]
    buf = xf.new_zeros((E, T * K, D))
    buf[ef, myp] = xf.repeat_interleave(K, dim=0)
    out = _moe_ffn(p, buf, cfg)
    return _gated_sum(out[ef, myp].reshape(T, K, D), gates)


def moe_capacity(S: int, cfg: ModelConfig) -> int:
    """The grouped path's per-group capacity, ceil(S K / E x factor), in
    Python floats as the reference computes it."""
    return int(math.ceil(S * cfg.top_k / cfg.n_experts
                         * cfg.capacity_factor))


def _moe_grouped(p, x, eidx, gates, cfg):
    """Group-local dispatch (prefill scale): each batch row is a group;
    expert positions come from a stable sort within the group, capacity
    ``moe_capacity(S)`` per expert, overflow tokens dropped."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    SK, C = S * K, moe_capacity(S, cfg)
    dev = x.device
    ef = eidx.reshape(B, SK)
    order = torch.argsort(ef, dim=1, stable=True)
    e_sorted = ef.gather(1, order)
    counts = _one_hot(ef, E).sum(dim=1)                        # (B, E)
    starts = torch.cumsum(counts, dim=1) - counts
    pos_sorted = (torch.arange(SK, device=dev)[None, :]
                  - starts.gather(1, e_sorted))
    keep = pos_sorted < C
    pos_c = torch.clamp_max(pos_sorted, C - 1)
    x_sorted = x.gather(1, (order // K)[..., None].expand(B, SK, D))
    bidx = torch.arange(B, device=dev)[:, None].expand(B, SK)
    # a dropped token's row goes to a spare slot C, which no expert reads
    buf = x.new_zeros((B, E, C + 1, D))
    buf[bidx, e_sorted, torch.where(keep, pos_c, C)] = x_sorted
    out = _moe_ffn(p, buf[:, :, :C], cfg)                      # (B, E, C, D)
    y_sorted = out[bidx, e_sorted, pos_c] * keep[..., None].to(x.dtype)
    inv = torch.argsort(order, dim=1)
    yk = y_sorted.gather(1, inv[..., None].expand(B, SK, D))
    return _gated_sum(yk.reshape(B * S, K, D), gates.reshape(B * S, K))


def _route(router: torch.Tensor, xf: torch.Tensor, K: int):
    """(probs (T, E), gates (T, K), expert indices (T, K)): float32 router
    logits, their softmax, the top k by a stable descending sort (the
    lower index first on ties, as ``jax.lax.top_k``), and the gates
    normalized by a true float32 division by max(sum, 1e-9)."""
    x32 = xf.to(torch.float32)
    if xf.is_cuda:
        logits = matmul(x32, router)
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        probs = e / _tree_sum(e)[..., None]
    else:
        # the reference's compiled CPU code: its dot's K order, XLA's exp
        # and its windowed sum
        logits = _dot(x32, router)
        e = prng.exp(logits - logits.amax(dim=-1, keepdim=True))
        probs = e / _window_sum(e)[..., None]
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = vals[:, :K], idx[:, :K]
    total = gates[:, 0]
    for k in range(1, K):
        total = total + gates[:, k]
    gates = gates / torch.clamp_min(total, 1e-9)[:, None]
    return probs, gates, eidx


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              path: str = "moe", want_aux: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, D) -> (y (B, S, D), the Switch-style load-balance aux loss
    or None).  T * K <= 4096 routed rows take the exact path
    (``_moe_small``), more the group-local one (``_moe_grouped``), as the
    reference chooses.  The aux loss is computed only when ``want_aux``
    (serving does not read it).  ``path`` prefixes the shared expert's
    plan paths ("moe/shared/w1", ...) and so its noise keys."""
    B, S, D = x.shape
    T, E, K = B * S, cfg.n_experts, cfg.top_k
    xf = x.reshape(T, D)
    probs, gates, eidx = _route(p["router"], xf, K)
    if T * K <= 4096:
        y = _moe_small(p, xf, eidx, gates, cfg)
    else:
        y = _moe_grouped(p, x, eidx.reshape(B, S, K), gates.reshape(B, S, K),
                         cfg)
    aux = None
    if want_aux:
        frac_tokens = _one_hot(eidx[:, 0], E).to(torch.float32).mean(dim=0)
        aux = (E * torch.sum(frac_tokens * probs.mean(dim=0))
               * cfg.router_aux_loss)
    if cfg.shared_expert_d_ff:
        y = y + mlp_apply(p["shared"], x, cfg,
                          path=f"{path}/shared").reshape(T, D)
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD): chunked parallel scan for prefill, one-step recurrence for
# decode
# ---------------------------------------------------------------------------
# On the CPU the float32 arithmetic follows the reference's compiled CPU
# code, which the port's tests hold it to: XLA's exp and log1p
# (``core/prng.py``), its blocked cumulative sum (``_scan_sum``), its
# multiply-adds fused (``_fma``) and its dot's summation order
# (``_dot``).  On CUDA the same formulas run as plain torch ops.


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
                dtype) -> Params:
    """Stacked (n_layers, ...) Mamba2 mixer params: the input projections
    kept separate (w_z, w_x, w_bc, w_dt; packing fuses them), depthwise
    convs per stream, and the float32 A_log, D_skip and dt_bias."""
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    W, dev = cfg.ssm_conv_width, gen.device
    f32 = dict(dtype=torch.float32, device=dev)

    def conv(c):
        return (torch.randn((n_layers, W, c), generator=gen, **f32)
                / W).to(dtype)
    dt0 = torch.exp(torch.rand((n_layers, H), generator=gen, **f32)
                    * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "w_z": _init_dense(gen, (n_layers, D, DI), dtype),
        "w_x": _init_dense(gen, (n_layers, D, DI), dtype),
        "w_bc": _init_dense(gen, (n_layers, D, 2 * N), dtype),
        "w_dt": _init_dense(gen, (n_layers, D, H), dtype),
        "conv_x": conv(DI),
        "conv_b": conv(2 * N),
        "conv_bias_x": torch.zeros((n_layers, DI), dtype=dtype, device=dev),
        "conv_bias_b": torch.zeros((n_layers, 2 * N), dtype=dtype,
                                   device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)).expand(
            n_layers, H).clone(),
        "D_skip": torch.ones((n_layers, H), **f32),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "gate_norm": torch.zeros((n_layers, DI), dtype=dtype, device=dev),
        "out_proj": _init_dense(gen, (n_layers, DI, D), dtype),
    }


def _exp(t: torch.Tensor) -> torch.Tensor:
    return torch.exp(t) if t.is_cuda else prng.exp(t)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float32: rounded once on the CPU, as XLA's CPU code
    contracts a multiply feeding an add."""
    return a * b + c if a.is_cuda else prng.fma(a, b, c)


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """log(1 + e^v) as jax evaluates it: max(v, 0) + log1p(e^-|v|)."""
    if v.is_cuda:
        return torch.clamp_min(v, 0) + torch.log1p(torch.exp(-v.abs()))
    return torch.clamp_min(v, 0) + prng.log1p(prng.exp(-v.abs()))


_SCAN_BASE = 16     # XLA's CPU rewrite of a long cumulative sum


def _scan_sum(t: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis.  On the CPU in the
    reference's compiled order: XLA rewrites a cumulative sum longer than
    16 into blocks of 16 (the axis zero-padded at its end), each summed in
    order, plus the exclusive sum of the block totals, which is itself
    taken the same way."""
    if t.is_cuda:
        return torch.cumsum(t, dim=-1)
    n = t.shape[-1]
    if n <= _SCAN_BASE:
        out = [t[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + t[..., i])
        return torch.stack(out, dim=-1)
    nb = -(-n // _SCAN_BASE)
    blk = _scan_sum(F.pad(t, (0, nb * _SCAN_BASE - n)).reshape(
        *t.shape[:-1], nb, _SCAN_BASE))
    before = F.pad(_scan_sum(blk[..., -1])[..., :-1], (1, 0))
    return (blk + before[..., None]).reshape(
        *t.shape[:-1], nb * _SCAN_BASE)[..., :n]


def _dot_lanes(m: int, n: int, nt: bool) -> int:
    """The number of interleaved K lanes of XLA's CPU dot for an (m, K) x
    (K, n) product (``nt``: the right operand stored (n, K)), measured on
    the shapes of this module's dots: each lane sums its k = l mod lanes
    in order with fused multiply-adds, and the lanes add pairwise."""
    if m == 1 or (not nt and m < 64 and n > 16):
        return 1
    return 4 if n < 32 else 2 if n < 64 else 1


def _dot(a: torch.Tensor, b: torch.Tensor, nt: bool = False
         ) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N), float32.  On the CPU in the order of
    the reference's compiled dot (``_dot_lanes``): products exact in
    float64, each lane's running sum rounded once per step."""
    if a.is_cuda:
        return a @ b
    M, K = a.shape[-2:]
    lanes = _dot_lanes(M, b.shape[-1], nt)
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    acc = []
    for lane in range(lanes):
        s = None
        for k in range(lane, K, lanes):
            p = a64[..., :, k, None] * b64[..., None, k, :]
            s = p.to(torch.float32) if s is None else (
                s.to(torch.float64) + p).to(torch.float32)
        acc.append(s)
    while len(acc) > 1:
        acc = [acc[i] + acc[i + 1] for i in range(0, len(acc), 2)]
    return acc[0]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., Q) log-decays -> (..., Q, Q): entry (i, j) the sum over
    (j, i] for j <= i, -inf above the diagonal."""
    Q = a.shape[-1]
    cs = _scan_sum(a)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, float("-inf"))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv: u (B, S, C), w (W, C), bias (C); ``state``
    (B, W-1, C) holds the previous W-1 inputs (zeros when None).  Every
    product and sum is rounded to u's dtype, as the reference's compiled
    bf16 code rounds them.  Returns (silu(out), the last W-1 inputs)."""
    W, S = w.shape[0], u.shape[1]
    if state is None:
        state = torch.zeros((u.shape[0], W - 1, u.shape[2]), dtype=u.dtype,
                            device=u.device)
    u_p = torch.cat([state.to(u.dtype), u], dim=1)
    out = u_p[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + u_p[:, i:i + S] * w[i]
    return _silu(out + b), u_p[:, S:]


def mamba2_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 ssm_state: Optional[torch.Tensor] = None,
                 conv_state=None, decode: bool = False):
    """x (B, S, D) -> (y (B, S, D), (new ssm state (B, H, P, N) float32,
    (new conv_x, new conv_bc))).  Prefill (``decode=False``) pads S to a
    multiple of the chunk with dt = 0 (identity decay, no update) and runs
    the chunked SSD scan from ``ssm_state`` (zeros when None);
    ``decode=True`` takes one step (S == 1) of the recurrence."""
    B, S, D = x.shape
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32
    proj = _dense_group(x, p, ("w_z", "w_x", "w_bc", "w_dt"), cfg, "mamba/")
    z, xc, BCc, dt_raw = (proj[n] for n in ("w_z", "w_x", "w_bc", "w_dt"))
    cs_x, cs_bc = conv_state if conv_state is not None else (None, None)
    xc, new_cx = _causal_conv(xc, p["conv_x"], p["conv_bias_x"], cs_x)
    BCc, new_cbc = _causal_conv(BCc, p["conv_b"], p["conv_bias_b"], cs_bc)
    Bc, Cc = BCc[..., :N], BCc[..., N:]
    dt = _softplus(dt_raw.to(f32) + p["dt_bias"])                 # (B,S,H)
    A = -_exp(p["A_log"])                                         # (H,)
    D_skip = p["D_skip"]

    if decode:
        xh = xc[:, 0].reshape(B, H, P).to(f32)
        Bh, Ch, dt0 = Bc[:, 0].to(f32), Cc[:, 0].to(f32), dt[:, 0]
        a = _exp(dt0 * A)                                         # (B,H)
        dBx = xh[..., None] * (Bh[:, None, :] * dt0[..., None])[:, :, None]
        state = (ssm_state if ssm_state is not None else
                 torch.zeros((B, H, P, N), dtype=f32, device=x.device))
        new_state = _fma(state, a[..., None, None], dBx)
        y = _dot(Ch[:, None, None, :],
                 new_state.reshape(B, H * P, N).transpose(1, 2)[:, None])
        y = _fma(D_skip[:, None], xh, y.reshape(B, H, P))
        y = y.reshape(B, 1, DI)
    else:
        Q = min(cfg.ssm_chunk, S)
        pad = -S % Q
        if pad:
            z, xc, Bc, Cc, dt = (F.pad(t, (0, 0, 0, pad))
                                 for t in (z, xc, Bc, Cc, dt))
        Sp = S + pad
        nc = Sp // Q
        xb = xc.to(f32).reshape(B, nc, Q, H, P)
        Bb = Bc.to(f32).reshape(B, nc, Q, N)
        Cb = Cc.to(f32).reshape(B, nc, Q, N)
        dtb = dt.reshape(B, nc, Q, H)
        a_t = (dtb * A).transpose(2, 3)                           # (B,nc,H,Q)
        L = _exp(_segsum(a_t))                                    # (B,nc,H,Q,Q)
        scores = _dot(Cb, Bb.transpose(-1, -2), nt=True)          # (B,nc,Q,Q)
        dt_k = dtb.transpose(2, 3)[:, :, :, None, :]              # (B,nc,H,1,Q)
        if x.is_cuda:
            y_diag = (scores[:, :, None] * L * dt_k) @ xb.permute(0, 1, 3, 2, 4)
        else:
            # the reference's pairing: (L dt) against (scores x), summed
            # over k as one dot per (b, c, h, q)
            lhs = (L * dt_k)[..., None, :]                        # (..,Q,1,K)
            rhs = (scores[:, :, None, :, :, None]
                   * xb.permute(0, 1, 3, 2, 4)[:, :, :, None])    # (..,Q,K,P)
            y_diag = _dot(lhs, rhs)[..., 0, :]
        a_cum = _scan_sum(a_t)                                    # (B,nc,H,Q)
        decay_end = _exp(a_cum[..., -1:] - a_cum)
        wx = (xb.permute(0, 1, 3, 4, 2)
              * (decay_end * dtb.transpose(2, 3))[:, :, :, None, :])
        states = _dot(wx.reshape(B, nc, H * P, Q), Bb).reshape(
            B, nc, H, P, N)
        chunk_decay = _exp(a_cum[..., -1])                        # (B,nc,H)
        h = (ssm_state if ssm_state is not None else
             torch.zeros((B, H, P, N), dtype=f32, device=x.device))
        h_prev = []
        for c in range(nc):
            h_prev.append(h)
            h = _fma(h, chunk_decay[:, c, :, None, None], states[:, c])
        new_state = h
        h_prev = torch.stack(h_prev, dim=1)                       # (B,nc,H,P,N)
        cw = Cb[:, :, None] * _exp(a_cum)[..., None]              # (B,nc,H,Q,N)
        y_off = _dot(cw, h_prev.transpose(-1, -2), nt=True)       # (B,nc,H,Q,P)
        y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(B, Sp, H, P)
        y = _fma(D_skip[:, None], xb.reshape(B, Sp, H, P), y)
        y = y.reshape(B, Sp, DI)

    # y rounded to bf16 times silu(z) feeds the gated norm unrounded (the
    # reference's compiled code drops that product's rounding: a product
    # of two bf16 values is exact in float32)
    g = y.to(x.dtype).to(f32) * _silu(z).to(f32)
    y = rms_norm(g, p["gate_norm"], cfg.norm_eps).to(x.dtype)
    out = _dense(y, p["out_proj"], cfg, "mamba/out_proj")
    if not decode and pad:
        out = out[:, :S]
    return out, (new_state, (new_cx, new_cbc))
