"""Model-zoo building blocks, dense subset: RMSNorm, RoPE, GQA attention
(blocked flash forward and plain), SwiGLU MLP.

Counterpart of ``repro/models/layers.py``.  Every projection routes
through ``_dense`` -> ``core.engine.CimEngine``, so packed weights
(``lm.pack_cim_params``) run on the emulated C-CIM macro; fused packed
groups (QKV, gate/up) run as one wide macro GEMM each.  Functions are
plain torch on tensors; ``*_init`` take an explicit ``torch.Generator``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.ccim import DEFAULT_CONFIG
from ..core.engine import CimEngine, FusedPackedCimWeights, PackedCimWeights
from .config import ModelConfig

Params = Dict[str, Any]

_NEG = -1e30          # masked score (the reference's constant)
_FAR = 10 ** 9        # k position of a padded / unwritten key


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------


def cim_engine(cfg: ModelConfig, path: Optional[str] = None) -> CimEngine:
    """The execution engine a model config resolves to (macro config,
    fidelity and kernel routing all come from the config)."""
    if cfg.cim_plan is not None:
        raise NotImplementedError("deployment plans are not ported yet")
    if cfg.cim_noise_seed is not None:
        raise NotImplementedError("analog-noise serving is not ported yet")
    return CimEngine(cfg=cfg.cim_cfg or DEFAULT_CONFIG,
                     fidelity=cfg.cim_fidelity,
                     use_kernel=cfg.cim_use_kernel)


def _dense(x: torch.Tensor, w, cfg: ModelConfig,
           path: Optional[str] = None) -> torch.Tensor:
    """x (..., K) @ w (K, N); packed weights run on the macro."""
    if isinstance(w, PackedCimWeights):
        if not cfg.cim_mode:
            raise ValueError(
                "packed CIM weights require cim_mode=True (packed params "
                "are macro array contents, not float matrices)")
        return cim_engine(cfg, path).matmul(x, w)
    if cfg.cim_mode:
        raise NotImplementedError(
            "unpacked CIM serving is not ported yet; pack the weights "
            "(lm.pack_cim_params)")
    return matmul(x, w)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype with float32 accumulation and one rounding.

    On the CPU the product runs as a float32 GEMM and is rounded once:
    that reproduces the reference's bf16 dots bit for bit, where the
    CPU's own bf16 GEMM sums in another order and flips a few bf16
    results.  On CUDA the bf16 GEMM accumulates in float32 already."""
    if x.is_cuda:
        return x @ w
    return (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)


FUSED_SEP = "+"   # fused param-leaf key: member names joined, e.g. "wq+wk+wv"


def fusion_partitions(cfg: ModelConfig, prefix: str, names) -> list:
    """Partition fusion-candidate projections by resolved engine:
    [(macro cfg, fidelity, members)] for groups of two or more.  Without
    a deployment plan every member resolves to the config's one engine."""
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


def _dense_fused(x: torch.Tensor, leaf: FusedPackedCimWeights,
                 cfg: ModelConfig, prefix: str, names
                 ) -> Dict[str, torch.Tensor]:
    """One activation quantization + one wide macro GEMM, split per
    segment."""
    if not cfg.cim_mode:
        raise ValueError(
            "fused packed CIM weights require cim_mode=True (packed params "
            "are macro array contents, not float matrices)")
    y = cim_engine(cfg, prefix + names[0]).matmul(x, leaf)
    return _split_segments(y, names, leaf.seg_dims)


def _dense_group(x: torch.Tensor, p: Params, names, cfg: ModelConfig,
                 prefix: str) -> Dict[str, torch.Tensor]:
    """Run a block's projections that all consume ``x``: pack-time fused
    leaves (key "wq+wk+wv") as one GEMM each, the rest per projection."""
    remaining = list(names)
    out: Dict[str, torch.Tensor] = {}
    for key, leaf in p.items():
        if isinstance(leaf, FusedPackedCimWeights):
            segs = key.split(FUSED_SEP)
            if all(s in remaining for s in segs):
                out.update(_dense_fused(x, leaf, cfg, prefix, segs))
                remaining = [n for n in remaining if n not in segs]
    for n in remaining:
        out[n] = _dense(x, p[n], cfg, prefix + n)
    return out


def _init_dense(gen: torch.Generator, shape, dtype, scale=None):
    """Normal(0, 1/d_in) weights of ``shape`` (..., d_in, d_out)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return w.to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(torch.float32))).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


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


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         n_pos: int) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) in [0, n_pos) -> x with each
    (i, i + D/2) pair rotated by pos / theta^(2i/D)."""
    half = x.shape[-1] // 2
    cos_t, sin_t = _rope_table(n_pos, half, float(theta), str(x.device))
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


def attention_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
                   dtype) -> Params:
    """Stacked (n_layers, ...) projections with TP-padded head counts; pad
    head slots are zero and masked after attention."""
    dh, d = cfg.head_dim, cfg.d_model
    hq, hkv = cfg.padded_heads, cfg.padded_kv_heads
    p = {"wq": _init_dense(gen, (n_layers, d, hq * dh), dtype),
         "wk": _init_dense(gen, (n_layers, d, hkv * dh), dtype),
         "wv": _init_dense(gen, (n_layers, d, hkv * dh), dtype),
         "wo": _init_dense(gen, (n_layers, hq * dh, d), dtype)}
    mask = _head_mask(cfg, gen.device)
    if mask is not None:
        mq = torch.repeat_interleave(mask, dh)[None, :].to(dtype)
        p["wq"] = p["wq"] * mq
        p["wo"] = p["wo"] * mq.T
        if hkv == hq:  # MHA: kv heads padded alongside q heads
            p["wk"] = p["wk"] * mq
            p["wv"] = p["wv"] * mq
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((n_layers, dh), dtype=dtype,
                                  device=gen.device)
        p["k_norm"] = torch.zeros((n_layers, dh), dtype=dtype,
                                  device=gen.device)
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


def _flash_fwd(cfg, n_prefix, q, k, v, q_pos, k_pos, is_local):
    """Forward over KV blocks in order with an f32 online softmax;
    returns (out (B, Hkv, G, Sq, Dh) f32, m, l)."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    blk = min(cfg.flash_block, k.shape[1])
    kb, vb, pb, _ = _flash_blocks(k, v, k_pos, blk)
    qg = _scale_q(q.reshape(B, Sq, Hkv, G, Dh))
    m = torch.full((B, Hkv, G, Sq), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, Dh), dtype=torch.float32,
                      device=q.device)
    for kc, vc, pc in zip(kb, vb, pb):
        s = _lane_scores(qg, kc.to(torch.float32))
        s = softcap(s, cfg.attn_softcap)
        msk = _mask(q_pos, pc, is_local, cfg.sliding_window, n_prefix)
        s = torch.where(msk[:, None, None, :, :], s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vc.dtype).to(torch.float32),
            vc.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out, m, l


def flash_attention(cfg: ModelConfig, n_prefix, q, k, v, q_pos, k_pos,
                    is_local) -> torch.Tensor:
    """Blocked attention forward, O(S) memory in the KV length."""
    B, Sq, Hq, Dh = q.shape
    out, _, _ = _flash_fwd(cfg, n_prefix, q, k, v, q_pos, k_pos, is_local)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)


_LANES = 8


def _lane_scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Scores (B, Hkv, G, Sq, Sk) of qg (B, Sq, Hkv, G, D) against
    k (B, Sk, Hkv, D), both float32, summed over D in the order the
    reference's compiled CPU dot uses at these shapes: 8 interleaved
    lanes (d = l, l + 8, ...), each summed in order, then a pairwise tree
    across the lanes.  Products of bf16 values are exact in float32, so
    only the order of the sums can differ; matching it keeps each score
    bit-identical, and a score one ulp off can flip a bf16 probability
    and then a macro ADC code downstream."""
    D = qg.shape[-1]
    prod = (qg.permute(0, 2, 3, 1, 4)[:, :, :, :, None, :]
            * k.permute(0, 2, 1, 3)[:, :, None, None, :, :])
    if D % _LANES:
        return prod.sum(dim=-1)
    prod = prod.reshape(*prod.shape[:-1], D // _LANES, _LANES)
    acc = prod[..., 0, :]
    for i in range(1, D // _LANES):
        acc = acc + prod[..., i, :]
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    return acc[..., 0]


def plain_attention(q, k, v, q_pos, k_pos, cfg: ModelConfig, is_local,
                    n_prefix=0) -> torch.Tensor:
    B, Sq, Hq, Dh = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = _scale_q(q.reshape(B, Sq, Hkv, G, Dh))
    s = _lane_scores(qg, k.to(torch.float32))
    s = softcap(s, cfg.attn_softcap)
    msk = _mask(q_pos, k_pos, is_local, cfg.sliding_window, n_prefix)
    s = torch.where(msk[:, None, None, :, :], s, _NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)          # jax.nn.softmax's form
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32)).to(v.dtype)
    return out.reshape(B, Sq, Hq, Dh)


def attention_apply(
    p: Params,
    x: torch.Tensor,                # (B, S, D)
    cfg: ModelConfig,
    positions: torch.Tensor,        # (B, S)
    is_local: bool,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_pos: Optional[torch.Tensor] = None,    # (B,) per-row write index
    path: str = "attn",
):
    """Returns (out (B, S, D), new_kv or None).

    With a contiguous ``kv_cache`` ((B, Smax, Hkv, Dh) each) row b writes
    its S new entries at ``cache_pos[b]`` IN PLACE (the reference returns
    updated copies; writing in place saves a cache copy per layer) and
    attends over its first ``cache_pos[b] + S`` entries."""
    B, S, _ = x.shape
    n_pos = kv_cache[0].shape[1] if kv_cache is not None else S
    q, k, v = _qkv(p, x, cfg, positions, n_pos, path)
    new_kv = None
    if kv_cache is not None:
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
        out = flash_attention(cfg, 0, q, k_full, v_full, positions, k_pos,
                              is_local)
    else:
        out = plain_attention(q, k_full, v_full, positions, k_pos, cfg,
                              is_local)
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


def mlp_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int, dtype,
             d_ff: Optional[int] = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    return {"w1": _init_dense(gen, (n_layers, cfg.d_model, d_ff), dtype),
            "w3": _init_dense(gen, (n_layers, cfg.d_model, d_ff), dtype),
            "w2": _init_dense(gen, (n_layers, d_ff, cfg.d_model), dtype)}


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the reference's rounding: sigmoid expands to
    1 / (1 + exp(-x)) and every op rounds to x's dtype (bf16).
    ``F.silu`` rounds once, which flips about a third of the bf16
    results -- and a flipped activation can flip a macro ADC code."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              path: str = "mlp") -> torch.Tensor:
    gu = _dense_group(x, p, ("w1", "w3"), cfg, f"{path}/")
    if cfg.act == "silu":
        h = _silu(gu["w1"]) * gu["w3"]
    else:
        h = F.gelu(gu["w1"], approximate="tanh") * gu["w3"]
    return _dense(h, p["w2"], cfg, f"{path}/w2")
