"""Decoder LM assembly, dense family: init, packing, prefill, decode.

Counterpart of ``repro/models/lm.py`` (dense serve subset):

  init(key, cfg, device=None)             -> params
  pack_cim_params(params, cfg, device=None) -> packed params
  prefill(params, cfg, tokens, cache)     -> logits, cache
  decode_step(params, cfg, token, cache)  -> logits, cache

The params tree has the reference's layout: ``params["layers"]`` holds
stacked leaves with a leading layer axis, and the forward walks the
layers in a Python loop (the reference scans them).  The KV cache is
updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from .. import resolve_device
from ..core.engine import (CimEngine, FusedPackedCimWeights,
                           PackedCimWeights)
from . import layers as L
from .config import ModelConfig

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(key: Union[int, torch.Generator], cfg: ModelConfig,
         device=None) -> Params:
    """Random params from ``key`` (a seed or a ``torch.Generator``), made
    on ``device`` (CUDA unless ``device="cpu"``).  The numbers differ from
    the reference's ``jax.random`` draws; the distributions match."""
    _dense_only(cfg)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(key))
    dev = gen.device
    dtype = torch_dtype(cfg.dtype)
    n, d = cfg.n_layers, cfg.d_model
    p: Params = {}
    p["embed"] = (torch.randn((cfg.vocab_size, d), generator=gen,
                              dtype=torch.float32, device=dev)
                  * 0.02).to(dtype)
    p["layers"] = {
        "attn": L.attention_init(gen, cfg, n, dtype),
        "ln1": torch.zeros((n, d), dtype=dtype, device=dev),
        "ln2": torch.zeros((n, d), dtype=dtype, device=dev),
        "mlp": L.mlp_init(gen, cfg, n, dtype),
    }
    p["ln_f"] = torch.zeros((d,), dtype=dtype, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = L._init_dense(gen, (d, cfg.vocab_size), dtype)
    return p


# ---------------------------------------------------------------------------
# prepacked CIM weights (weight-stationary serving)
# ---------------------------------------------------------------------------


# Projection leaves consumed by layers._dense; embeddings, lm_head and
# norms stay float.
_CIM_PACKABLE = frozenset({"wq", "wk", "wv", "wo", "w1", "w2", "w3"})

# Projection groups that consume the same input activation.
_FUSE_GROUPS = (("wq", "wk", "wv"),            # attention QKV
                ("w1", "w3"))                  # SwiGLU gate/up


def _pack_single(path: str, v, cfg: ModelConfig):
    eng = L.cim_engine(cfg, path)
    if eng.fidelity == "float":
        return v
    if v.dim() in (2, 3):                    # (K, N) or (layers, K, N)
        return eng.pack(v)
    return v


def _pack_tree(tree: Params, cfg: ModelConfig, path=()) -> Params:
    """Fusion-aware packing walk: each fusion group present at a dict
    level packs as ONE ``FusedPackedCimWeights`` under a "wq+wk+wv"-style
    key (column-local scales and quantization keep it bit-identical per
    segment to separate packs); other projections pack alone."""
    out = dict(tree)
    consumed = set()
    if cfg.cim_fuse:
        for members in _FUSE_GROUPS:
            present = [m for m in members
                       if isinstance(tree.get(m), torch.Tensor)
                       and tree[m].dim() in (2, 3) and m in _CIM_PACKABLE]
            if len(present) < 2:
                continue
            prefix = "/".join(path) + "/" if path else ""
            for ecfg, _, g in L.fusion_partitions(cfg, prefix, present):
                wcat = torch.cat([tree[m] for m in g], dim=-1)
                out[L.FUSED_SEP.join(g)] = FusedPackedCimWeights(
                    packed=CimEngine(cfg=ecfg).pack(wcat),
                    seg_names=tuple(g),
                    seg_dims=tuple(int(tree[m].shape[-1]) for m in g))
                del wcat
                consumed.update(g)
    for k, v in tree.items():
        if k in consumed:
            del out[k]
            continue
        sub = path if k == "layers" else path + (k,)
        if isinstance(v, dict):
            out[k] = _pack_tree(v, cfg, sub)
        elif k in _CIM_PACKABLE:
            out[k] = _pack_single("/".join(sub), v, cfg)
    return out


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def pack_cim_params(params: Params, cfg: ModelConfig, device=None) -> Params:
    """Replace every _dense-consumed projection with packed macro array
    contents, on ``device`` (CUDA unless ``device="cpu"``).  With
    cfg.cim_fuse, QKV and gate/up pack as one wide fused leaf each."""
    if not cfg.cim_mode:
        raise ValueError("pack_cim_params requires cfg.cim_mode=True")
    return _pack_tree(_to_device(params, resolve_device(device)), cfg)


# ---------------------------------------------------------------------------
# shared forward machinery
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    """Layer ``i`` of the stacked ``params["layers"]`` tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (PackedCimWeights, FusedPackedCimWeights)):
        return tree.layer(i)
    return tree[i]




def _embed(p, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


def _logits(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, p["ln_f"], cfg.norm_eps)
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    logits = L.matmul(x, head.to(x.dtype))
    return L.softcap(logits.to(torch.float32), cfg.logit_softcap)


def _attn_block(blk, x, cfg, positions, is_local, kv, cache_pos):
    h, new_kv = L.attention_apply(
        blk["attn"], L.rms_norm(x, blk["ln1"], cfg.norm_eps), cfg, positions,
        is_local, kv_cache=kv, cache_pos=cache_pos)
    # the reference's compiled step normalizes the UNROUNDED float32 sum
    # x + h (XLA fuses the add into the norm's convert), while the
    # residual stream itself carries the rounded sum; the port does both
    xf = x.to(torch.float32) + h.to(torch.float32)
    x = xf.to(x.dtype)
    h = L.mlp_apply(blk["mlp"],
                    L.rms_norm(xf, blk["ln2"], cfg.norm_eps).to(x.dtype),
                    cfg)
    return x + h, new_kv


# ---------------------------------------------------------------------------
# KV cache, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Decode cache for ``batch`` sequences of up to ``max_seq``; ``pos``
    is each row's write position."""
    _dense_only(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.padded_kv_heads, cfg.head_dim)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _stack(params, cfg, x, positions, cache, cache_pos):
    for i in range(cfg.n_layers):
        x, _ = _attn_block(_layer(params["layers"], i), x, cfg, positions,
                           cfg.layer_is_local(i),
                           kv=(cache["k"][i], cache["v"][i]),
                           cache_pos=cache_pos)
    return x


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt, fill the cache, return last-position logits
    (B, 1, V) float32."""
    _dense_only(cfg)
    x = _embed(params, cfg, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    cache = dict(cache)
    x = _stack(params, cfg, x, positions, cache,
               torch.zeros((B,), dtype=torch.int32, device=x.device))
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return _logits(params, cfg, x[:, -1:, :]), cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: Dict,
                live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """token (B, 1) -> logits (B, 1, V); cache advanced by one position."""
    _dense_only(cfg)
    if live is not None:
        raise NotImplementedError("per-slot liveness (continuous batching) "
                                  "is not ported yet")
    x = _embed(params, cfg, token)
    pos = cache["pos"]
    cache = dict(cache)
    x = _stack(params, cfg, x, pos[:, None], cache, pos)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache
