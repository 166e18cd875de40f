"""Decoder LM assembly for every family of the reference: init, packing,
prefill, decode, and the slot-level cache ops of continuous batching.

Counterpart of ``repro/models/lm.py``: the dense family, [attn, mlp] x L;
the moe family, [attn, moe] x L, with arctic's dense residual mlp beside
the moe where ``d_ff`` is set; the ssm family, [mamba2] x L; the hybrid
family, groups of ``shared_attn_period`` mamba2 layers each followed by
ONE shared attn + mlp block, zamba2; the vlm and audio families, the
dense stack over frontend embeddings (a stub's, given by the caller)
placed ahead of the token embeddings, which the vlm's prefix-LM mask
lets attend to each other both ways (paligemma):

  init(key, cfg, device=None)             -> params
  pack_cim_params(params, cfg, device=None) -> packed params
  iter_packable_paths(params)             -> plan path -> leaf shape
  forward(params, cfg, tokens, frontend_embs=None) -> logits, aux
  init_cache / init_paged_cache           -> contiguous / paged KV cache
  prefill(params, cfg, tokens, cache, frontend_embs=None) -> logits, cache
  decode_step(params, cfg, token, cache, live=None) -> logits, cache
  verify_step(params, cfg, tokens, cache, live=None) -> logits, cache
  prefill_into_slot / prefill_chunk_into_slot / reset_slot

The params tree has the reference's layout: ``params["layers"]`` holds
stacked leaves with a leading layer axis, and the forward walks the
layers in a Python loop (the reference scans them); the hybrid's
``params["shared"]`` holds the one shared block's unstacked (2-D)
leaves.  KV entries are written into the cache's tensors in place (the
reference returns updated copies), and so are the SSM family's
recurrent ``ssm``, ``conv_x`` and ``conv_bc`` entries and the hybrid's
``shared_k`` / ``shared_v``; ``pos`` comes back as a new tensor from
prefill, ``decode_step`` advances it in place, and the slot ops write
their slot of every entry in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..core import prng
from ..core.engine import (CimEngine, FusedPackedCimWeights,
                           PackedCimWeights, pack_cim_layers)
from . import layers as L
from .config import ModelConfig

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
RECURRENT_FAMILIES = ("ssm", "hybrid")     # carry SSM and conv state


def check_family(cfg: ModelConfig) -> None:
    """Refuse a family the port does not know."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(PORTED_FAMILIES)})")


def check_speculative(cfg: ModelConfig) -> None:
    """Refuse speculative decoding where it cannot roll back: the ssm and
    hybrid families' recurrent state advances destructively."""
    if cfg.family in RECURRENT_FAMILIES:
        raise NotImplementedError(
            "speculative decoding needs positional KV rollback; the "
            f"{cfg.family!r} family carries recurrent SSM/conv state that "
            "a rejected draft block cannot roll back")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(key: Union[int, torch.Generator], cfg: ModelConfig,
         device=None) -> Params:
    """Random params from ``key`` (a seed or a ``torch.Generator``), made
    on ``device`` (CUDA unless ``device="cpu"``).  The numbers differ from
    the reference's ``jax.random`` draws; the distributions match."""
    check_family(cfg)
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
    if cfg.family in RECURRENT_FAMILIES:
        p["layers"] = {
            "mamba": L.mamba2_init(gen, cfg, n, dtype),
            "ln1": torch.zeros((n, d), dtype=dtype, device=dev),
        }
        if cfg.family == "hybrid":
            p["shared"] = _shared_block_init(gen, cfg, dtype)
    else:
        p["layers"] = {
            "attn": L.attention_init(gen, cfg, n, dtype),
            "ln1": torch.zeros((n, d), dtype=dtype, device=dev),
            "ln2": torch.zeros((n, d), dtype=dtype, device=dev),
        }
        if cfg.family == "moe":
            p["layers"]["moe"] = L.moe_init(gen, cfg, n, dtype)
        if cfg.family != "moe" or cfg.d_ff:   # arctic's dense residual
            p["layers"]["mlp"] = L.mlp_init(gen, cfg, n, dtype)
    p["ln_f"] = torch.zeros((d,), dtype=dtype, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = L._init_dense(gen, (d, cfg.vocab_size), dtype)
    return p


def _shared_block_init(gen: torch.Generator, cfg: ModelConfig,
                       dtype) -> Params:
    """The hybrid's one shared attn + mlp block: unstacked 2-D leaves."""
    d, dev = cfg.d_model, gen.device
    return {"attn": L.attention_init(gen, cfg, None, dtype),
            "mlp": L.mlp_init(gen, cfg, None, dtype),
            "ln1": torch.zeros((d,), dtype=dtype, device=dev),
            "ln2": torch.zeros((d,), dtype=dtype, device=dev)}


# ---------------------------------------------------------------------------
# prepacked CIM weights (weight-stationary serving)
# ---------------------------------------------------------------------------


# Projection leaves consumed by layers._dense; embeddings, lm_head, the
# MoE router and expert tensors, convs and norms stay float.
_CIM_PACKABLE = frozenset({
    "wq", "wk", "wv", "wo",                      # attention
    "w1", "w2", "w3",                            # MLP
    "w_z", "w_x", "w_bc", "w_dt", "out_proj",    # mamba2 projections
})

# Projection groups that consume the same input activation.
_FUSE_GROUPS = (("wq", "wk", "wv"),              # attention QKV
                ("w1", "w3"),                    # SwiGLU gate/up
                ("w_z", "w_x", "w_bc", "w_dt"))  # mamba2 input projections


def _packable(key: str, path: Tuple[str, ...]) -> bool:
    """Whether leaf ``key`` at tree ``path`` is a ``_dense`` projection:
    the MoE experts reuse the names w1/w2/w3 directly under "moe" but feed
    the expert GEMMs (the shared expert under "moe/shared" is packable)."""
    return key in _CIM_PACKABLE and not (path and path[-1] == "moe")


def _walk_packable(tree, visit, path=()):
    """Rebuild ``tree`` with ``visit(plan_path, leaf)`` applied to every
    projection leaf ``layers._dense`` consumes.  ``plan_path`` is the
    deployment plan's path: tree keys joined with "/", the stacked key
    "layers" dropped (one entry covers every layer), e.g. "attn/wq",
    "mamba/out_proj" or the hybrid's "shared/mlp/w2".  The level directly
    under "moe" holds expert tensors, not projections."""
    out = {}
    for k, v in tree.items():
        sub = path if k == "layers" else path + (k,)
        if isinstance(v, dict):
            out[k] = _walk_packable(v, visit, sub)
        elif _packable(k, path):
            out[k] = visit("/".join(sub), v)
        else:
            out[k] = v
    return out


def iter_packable_paths(params: Params) -> Dict[str, Tuple[int, ...]]:
    """Deployment-plan path -> leaf shape for every ``_dense`` projection:
    the planner's site list (a stacked leaf appears once, with its
    (layers, K, N) shape)."""
    sites: Dict[str, Tuple[int, ...]] = {}

    def visit(path, v):
        sites[path] = tuple(v.shape)
        return v

    _walk_packable(params, visit)
    return sites


def _pack_single(path: str, v, cfg: ModelConfig):
    if not isinstance(v, torch.Tensor):
        return v                             # packed already
    eng = L.cim_engine(cfg, path)
    if eng.fidelity == "float":
        return v
    if v.dim() in (2, 3):                    # (K, N) or (layers, K, N)
        return eng.pack(v)
    return v


def _pack_group(ws, cfg) -> PackedCimWeights:
    """One pack of a fusion group's weights concatenated along N; a
    stacked group is concatenated and packed one layer at a time, so no
    whole-stack concatenation is ever made."""
    if ws[0].dim() == 3:
        return pack_cim_layers(lambda i: torch.cat([w[i] for w in ws], -1),
                               ws[0].shape[0], cfg)
    return CimEngine(cfg=cfg).pack(torch.cat(ws, dim=-1))


def _pack_tree(tree: Params, cfg: ModelConfig, path=(),
               consume: bool = False) -> Params:
    """Fusion-aware packing walk.  At every dict level each fusion group
    splits into partitions by resolved plan entry
    (``layers.fusion_partitions``); a partition of two or more sites
    packs as ONE ``FusedPackedCimWeights`` under a "wq+wk+wv"-style key,
    under its entry's config (column-local scales and quantization keep
    it bit-identical per segment to separate packs).  Every other
    projection packs alone under its own entry, and a site the plan
    keeps ``float`` stays a raw matrix.  ``consume`` deletes each packed
    raw leaf from ``tree`` as soon as its pack exists."""
    out = dict(tree)
    if cfg.cim_fuse:
        for members in _FUSE_GROUPS:
            present = [m for m in members
                       if isinstance(tree.get(m), torch.Tensor)
                       and tree[m].dim() in (2, 3) and _packable(m, path)]
            if len(present) < 2:
                continue
            prefix = "/".join(path) + "/" if path else ""
            for ecfg, _, g in L.fusion_partitions(cfg, prefix, present):
                out[L.FUSED_SEP.join(g)] = FusedPackedCimWeights(
                    packed=_pack_group([tree[m] for m in g], ecfg),
                    seg_names=tuple(g),
                    seg_dims=tuple(int(tree[m].shape[-1]) for m in g))
                for m in g:
                    del out[m]
                    if consume:
                        del tree[m]
    for k in list(out):
        sub = path if k == "layers" else path + (k,)
        if isinstance(out[k], dict):
            out[k] = _pack_tree(out[k], cfg, sub, consume)
        elif _packable(k, path):
            out[k] = _pack_single("/".join(sub), out[k], cfg)
            if consume:
                del tree[k]
    return out


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _to_device_in_place(tree, device) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _to_device_in_place(v, device)
        elif isinstance(v, torch.Tensor):
            tree[k] = v.to(device)


def pack_cim_params(params: Params, cfg: ModelConfig, device=None,
                    consume: bool = False) -> Params:
    """Replace every _dense-consumed projection with packed macro array
    contents, on ``device`` (CUDA unless ``device="cpu"``).  Under a
    deployment plan each projection packs under its own entry's config
    and ``float`` sites stay raw.  With cfg.cim_fuse, QKV, gate/up and
    the mamba2 input projections pack as one wide fused leaf per
    plan-compatible partition.  Leaves packed already stay as they are.
    ``consume`` (for a caller that owns
    ``params`` and drops it) moves ``params``' leaves to ``device`` in
    place and deletes each raw projection from it once it is packed, so
    the raw weights and the pack are never both whole in memory: at
    full width a 14 B-weight model's raw stack and pack do not fit one
    card together."""
    if not cfg.cim_mode:
        raise ValueError("pack_cim_params requires cfg.cim_mode=True")
    dev = resolve_device(device)
    if consume:
        _to_device_in_place(params, dev)
        return _pack_tree(params, cfg, consume=True)
    return _pack_tree(_to_device(params, dev), cfg)


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


def _unstack(tree, n: int) -> list:
    """The n layers of a stacked tree as views, through one ``unbind``
    per leaf: where autograd records, each leaf's gradient is then one
    stack of the layers' gradients, not n full-size selects."""
    if isinstance(tree, dict):
        cols = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]
    if isinstance(tree, (PackedCimWeights, FusedPackedCimWeights)):
        return [tree.layer(i) for i in range(n)]
    return list(torch.unbind(tree))


def _remat(remat: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where ``remat`` and
    autograd records (the reference's ``jax.checkpoint``): its
    activations are recomputed in the backward, every kernel of it
    launched a second time."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)




def _embed(p, cfg: ModelConfig, tokens: torch.Tensor,
           frontend_embs: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, int]:
    """(embeddings (B, S, D), n_prefix): the tokens' embeddings, with a
    vlm or audio model's ``frontend_embs`` (B, F, D) cast to the model
    dtype ahead of them; ``n_prefix`` is F under the prefix-LM mask
    (``cfg.prefix_lm``), else 0."""
    x = p["embed"][tokens]
    if cfg.family in ("vlm", "audio") and frontend_embs is not None:
        x = torch.cat([frontend_embs.to(device=x.device, dtype=x.dtype), x],
                      dim=1)
    n_prefix = (frontend_embs.shape[1]
                if cfg.prefix_lm and frontend_embs is not None else 0)
    return x, n_prefix


def _logits(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """logits of the final hidden ``x``: the model's dtype, or the float32
    residual sum a hybrid's last shared block leaves unrounded (see
    ``_attn_block``).  On the CPU the head's float32 sums take XLA-CPU's
    order for the call's rows (``layers.lm_head_order``)."""
    x = L.rms_norm(x, p["ln_f"], cfg.norm_eps).to(torch_dtype(cfg.dtype))
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    M = x.numel() // x.shape[-1]
    order = L.lm_head_order(M, *head.shape, cfg.tie_embeddings)
    logits = L.head_matmul(x, head.to(x.dtype), order)
    return L.softcap(logits.to(torch.float32), cfg.logit_softcap)


def _attn_block(blk, x, cfg, positions, is_local, kv=None, cache_pos=None,
                block_table=None, write_mask=None, prefix="",
                unrounded=False, aux=None, n_prefix=0):
    """``prefix`` qualifies the plan paths (and so the plan entries and
    the noise keys) of the block's projections: "" for the stacked
    layers ("attn/wq", ...), "shared/" for the hybrid's shared block.
    ``unrounded`` returns the block's output as the float32 sum x + h:
    where the block is the hybrid's last op, the reference's compiled
    step feeds that sum to the final norm unrounded, as it does inside
    the block (below).  A moe block runs the moe on the normed sum, plus
    arctic's dense mlp on the same input where the block has one; a list
    ``aux`` receives the moe's aux loss.  Keys below ``n_prefix`` are
    seen by every query (the vlm's prefix-LM mask)."""
    h, new_kv = L.attention_apply(
        blk["attn"], L.rms_norm(x, blk["ln1"], cfg.norm_eps), cfg, positions,
        is_local, kv_cache=kv, cache_pos=cache_pos, path=prefix + "attn",
        block_table=block_table, write_mask=write_mask, n_prefix=n_prefix)
    # the reference's compiled step normalizes the UNROUNDED float32 sum
    # x + h (XLA fuses the add into the norm's convert), while the
    # residual stream itself carries the rounded sum; the port does both
    xf = x.to(torch.float32) + h.to(torch.float32)
    x = xf.to(x.dtype)
    hn = L.rms_norm(L.round_grad(xf, x.dtype), blk["ln2"],
                    cfg.norm_eps).to(x.dtype)
    if "moe" in blk:
        h, a = L.moe_apply(blk["moe"], hn, cfg, path=prefix + "moe",
                           want_aux=aux is not None)
        if aux is not None:
            aux.append(a)
        if "mlp" in blk:   # arctic: the dense residual beside the moe
            h = h + L.mlp_apply(blk["mlp"], hn, cfg, path=prefix + "mlp")
    else:
        h = L.mlp_apply(blk["mlp"], hn, cfg, path=prefix + "mlp")
    if unrounded:
        return x.to(torch.float32) + h.to(torch.float32), new_kv
    return x + h, new_kv


def _mamba_block(blk, x, cfg, ssm_state=None, conv_state=None,
                 decode=False):
    """x + mamba2(rms_norm(x)): the recurrent families' layer; returns
    (x, (new ssm state, new conv states))."""
    h, new = L.mamba2_apply(blk["mamba"],
                            L.rms_norm(x, blk["ln1"], cfg.norm_eps), cfg,
                            ssm_state=ssm_state, conv_state=conv_state,
                            decode=decode)
    return x + h, new


def _groups(cfg: ModelConfig):
    """The recurrent stack's schedule: (lo, hi, g) runs mamba layers
    [lo, hi) and then, where g is not None, shared-block invocation g
    (the hybrid's groups of ``shared_attn_period``; the ssm family and a
    hybrid's remainder group have none)."""
    n = cfg.n_layers
    period = cfg.shared_attn_period if cfg.family == "hybrid" else 0
    if not period:
        return [(0, n, None)]
    out = [(g * period, (g + 1) * period, g) for g in range(n // period)]
    done = n // period * period
    return out + ([(done, n, None)] if done < n else [])


def n_shared_invocations(cfg: ModelConfig) -> int:
    """Shared-block invocations a forward runs (0 outside the hybrid)."""
    return sum(g is not None for _, _, g in _groups(cfg))


# ---------------------------------------------------------------------------
# forward without a cache (the planner's calibration forward)
# ---------------------------------------------------------------------------


def _hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embs: Optional[torch.Tensor] = None,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final hidden states, as ``_logits`` takes them (a hybrid ending
    in its shared block leaves them float32, unrounded), and the aux loss:
    the moe layers' summed in layer order, 0 for the other families.
    ``remat`` recomputes each stacked layer in the backward, as the
    reference's scanned body is (the hybrid's shared blocks are not)."""
    check_family(cfg)
    auxs: list = []
    x, n_prefix = _embed(params, cfg, tokens, frontend_embs)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    layers = _unstack(params["layers"], cfg.n_layers)
    if cfg.family in RECURRENT_FAMILIES:
        groups = _groups(cfg)
        mamba = lambda blk, x: _mamba_block(blk, x, cfg)[0]
        for lo, hi, g in groups:
            for i in range(lo, hi):
                x = _remat(remat, mamba, layers[i], x)
            if g is not None:
                x, _ = _attn_block(params["shared"], x, cfg, positions,
                                   False, prefix="shared/",
                                   unrounded=hi == groups[-1][1])
    else:
        def block(i, blk, x):
            a: list = []
            x, _ = _attn_block(blk, x, cfg, positions, cfg.layer_is_local(i),
                               aux=a, n_prefix=n_prefix)
            return (x, *a)
        for i in range(cfg.n_layers):
            x, *a = _remat(remat, block, i, layers[i], x)
            auxs += a
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in auxs:
        aux = aux + a
    return x, aux


def hidden_states(params, cfg: ModelConfig, tokens: torch.Tensor,
                  frontend_embs: Optional[torch.Tensor] = None,
                  remat: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> final hidden (B, F + S, D), aux loss (the moe
    layers' load-balance loss, 0 for the other families).
    ``frontend_embs`` (B, F, D) goes ahead of the tokens in the vlm and
    audio families (F = 0 without it; the other families ignore it).
    ``remat`` (where autograd records) recomputes each stacked layer's
    forward in the backward; the values are the same either way."""
    x, aux = _hidden(params, cfg, tokens, frontend_embs, remat)
    return x.to(torch_dtype(cfg.dtype)), aux


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embs: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> logits (B, F + S, V) float32, aux loss: every
    position through the model with no cache (causal attention over the
    sequence itself, the vlm's frontend prefix seen both ways), packed or
    raw weights, under ``cfg``'s plan and noise; ``frontend_embs`` as in
    ``hidden_states``."""
    x, aux = _hidden(params, cfg, tokens, frontend_embs, remat)
    return _logits(params, cfg, x), aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


CE_TARGET_ELEMS = 2e9  # global fp32 logits elements per CE chunk


def _ce_chunk(batch: int, seq: int, vocab: int) -> int:
    """Vocab/batch-adaptive CE chunk: bound the transient logits tensor to
    ~CE_TARGET_ELEMS global elements (a power of two, 32 to 1,024, at
    most ``seq``)."""
    c = int(CE_TARGET_ELEMS / max(batch * vocab, 1))
    c = 1 << max(c.bit_length() - 1, 5)  # floor pow2, >= 32
    return max(32, min(1024, c, seq))


def _logsumexp(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.logsumexp`` over the last axis, the max held constant; on
    the CPU with XLA's exp, windowed sum and log."""
    amax = z.detach().amax(dim=-1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, 0.0)
    if z.is_cuda:
        return torch.log(torch.exp(z - amax).sum(dim=-1)) + amax[..., 0]
    return prng.log(L._window_sum(prng.exp(z - amax))) + amax[..., 0]


def _ce_sum(xc: torch.Tensor, tc: torch.Tensor, head: torch.Tensor,
            cap: Optional[float]) -> torch.Tensor:
    """Summed next-token CE of one chunk: xc (B, c, D), targets tc (B, c)
    with -1 at padded positions."""
    logits = L.softcap(L.matmul(xc, head).to(torch.float32), cap)
    sel = torch.gather(logits, -1, tc.clamp_min(0).long()[..., None])[..., 0]
    valid = (tc >= 0).to(torch.float32)
    return ((_logsumexp(logits) - sel) * valid).sum()


def lm_loss(params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embs: Optional[torch.Tensor] = None,
            remat: bool = True) -> torch.Tensor:
    """Next-token CE over the text positions (the frontend prefix
    excluded), plus the moe's aux loss.  The (B, S, V) logits are never
    whole: CE runs over sequence chunks of ``_ce_chunk``, each recomputed
    in the backward under ``remat``, so the transient is (B, c, V)."""
    x, aux = hidden_states(params, cfg, tokens, frontend_embs, remat)
    n_front = x.shape[1] - tokens.shape[1]
    x = L.rms_norm(x[:, n_front:, :], params["ln_f"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(x.dtype)
    xs, tgt = x[:, :-1, :], tokens[:, 1:].to(x.device)
    B, S1, _ = xs.shape
    c = _ce_chunk(B, S1, cfg.vocab_size)
    pad = -S1 % c
    if pad:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
        tgt = torch.nn.functional.pad(tgt, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, S1 + pad, c):
        total = total + _remat(remat, _ce_sum, xs[:, lo:lo + c],
                               tgt[:, lo:lo + c], head, cfg.logit_softcap)
    return total / (B * S1) + aux


# ---------------------------------------------------------------------------
# KV cache, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Decode cache for ``batch`` sequences of up to ``max_seq``; ``pos``
    is each row's write position.  The dense family keeps KV rows; the
    ssm family keeps, per layer and row, the float32 SSM state (H, P, N)
    and the last W-1 inputs of each conv (``conv_x``, ``conv_bc``); the
    hybrid adds the shared block's KV rows per invocation (``shared_k``,
    ``shared_v``: (n_inv, batch, max_seq, Hkv, Dh))."""
    check_family(cfg)
    dev = resolve_device(device)
    c = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    kv = (batch, max_seq, cfg.padded_kv_heads, cfg.head_dim)
    if cfg.family in RECURRENT_FAMILIES:
        c.update(_ssm_entries(cfg, batch, dtype, dev))
        c.update(_shared_kv(cfg, kv, dtype, dev))
    else:
        c["k"] = torch.zeros((cfg.n_layers, *kv), dtype=dtype, device=dev)
        c["v"] = torch.zeros((cfg.n_layers, *kv), dtype=dtype, device=dev)
    return c


def _shared_kv(cfg: ModelConfig, shape, dtype, dev
               ) -> Dict[str, torch.Tensor]:
    """The hybrid's shared-block KV, one ``shape`` entry per invocation
    (none for the ssm family)."""
    n_inv = n_shared_invocations(cfg)
    if not n_inv:
        return {}
    return {k: torch.zeros((n_inv, *shape), dtype=dtype, device=dev)
            for k in ("shared_k", "shared_v")}


def _ssm_entries(cfg: ModelConfig, batch: int, dtype, dev
                 ) -> Dict[str, torch.Tensor]:
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    W, n = cfg.ssm_conv_width, cfg.n_layers
    return {"ssm": torch.zeros((n, batch, H, P, N), dtype=torch.float32,
                               device=dev),
            "conv_x": torch.zeros((n, batch, W - 1, cfg.d_inner),
                                  dtype=dtype, device=dev),
            "conv_bc": torch.zeros((n, batch, W - 1, 2 * N), dtype=dtype,
                                   device=dev)}


def init_paged_cache(cfg: ModelConfig, batch: int, n_blocks: int,
                     block_size: int, n_tbl: int, dtype=torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    """The PAGED decode cache: per-layer global KV block pools
    ``(n_layers, n_blocks, block_size, hkv, dh)`` shared by every slot,
    plus a per-slot block table; slot b's logical row p resolves through
    ``table[b, p // block_size]``.  The ``"table"`` key is what flips
    prefill/decode_step and the slot helpers into paged mode.  Block 0 is
    the trash block (launch/scheduler.py): an all-zero table row, the
    reset state, points every position at rows no live slot reads.  The
    SSM and conv state stays dense per slot (it is O(1) per slot, not
    O(max_seq)); the ssm family has no KV pools, the hybrid one pair per
    shared-block invocation (``shared_k``, ``shared_v``: (n_inv,
    n_blocks, block_size, Hkv, Dh))."""
    check_family(cfg)
    dev = resolve_device(device)
    c = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
         "table": torch.zeros((batch, n_tbl), dtype=torch.int32, device=dev)}
    kv = (n_blocks, block_size, cfg.padded_kv_heads, cfg.head_dim)
    if cfg.family in RECURRENT_FAMILIES:
        c.update(_ssm_entries(cfg, batch, dtype, dev))
        c.update(_shared_kv(cfg, kv, dtype, dev))
    else:
        c["k"] = torch.zeros((cfg.n_layers, *kv), dtype=dtype, device=dev)
        c["v"] = torch.zeros((cfg.n_layers, *kv), dtype=dtype, device=dev)
    return c


# ---------------------------------------------------------------------------
# slot-level cache ops (continuous batching, launch/scheduler.py)
# ---------------------------------------------------------------------------
# Every cache entry carries the pool (batch) dimension at axis 1 (stacked
# per layer) except "pos" and "table", which carry it at axis 0.  In PAGED
# caches the KV entries are global block pools with no batch axis: the
# slot helpers pass them through whole, and per-slot state is "pos",
# "table" and the SSM/conv entries.  ``slot`` is a Python int (the
# scheduler picks slots on the host).


_POOL_KEYS = frozenset({"k", "v", "shared_k", "shared_v"})


def is_paged(cache: Dict) -> bool:
    return "table" in cache


def _slot_axis(key: str) -> int:
    return 0 if key in ("pos", "table") else 1


def slot_slice(cache: Dict, slot: int) -> Dict:
    """A batch-1 view of one pool slot (same structure, batch=1).  The
    entries are views: writes into them land in the pool.  Paged KV pools
    are returned whole -- they are shared, and the slot's table row is
    what scopes them."""
    paged = is_paged(cache)
    return {k: (v if paged and k in _POOL_KEYS else
                v.narrow(_slot_axis(k), slot, 1))
            for k, v in cache.items()}


def slot_update(cache: Dict, sub: Dict, slot: int) -> Dict:
    """Write a batch-1 sub-cache into pool slot ``slot`` in place; returns
    ``cache``.  Paged pools are shared and already hold the sub-cache's
    writes."""
    paged = is_paged(cache)
    for k, v in cache.items():
        if paged and k in _POOL_KEYS:
            continue
        dst = v.narrow(_slot_axis(k), slot, 1)
        if sub[k].data_ptr() != dst.data_ptr():
            dst.copy_(sub[k])
    return cache


def _zeroed_slot(cache: Dict, slot: int) -> Dict:
    """A zeroed batch-1 sub-cache for ``slot`` -- the reset state.  KV
    rows do not strictly need zeroing (the attention validity mask hides
    everything at or beyond ``pos``), but SSM/conv state feeds the
    recurrence as its initial value, so a freed slot must be cleared
    before its next prefill; one op clears every entry.
    Paged caches keep the pools (shared) AND the slot's table row: the
    scheduler's allocator arms the table before prefilling and clears it
    at harvest, and a reset between the two must not sever the mapping."""
    paged = is_paged(cache)
    sub = slot_slice(cache, slot)
    return {k: (v if paged and k in _POOL_KEYS | {"table"}
                else torch.zeros_like(v))
            for k, v in sub.items()}


def reset_slot(cache: Dict, slot: int) -> Dict:
    """Zero one slot's state (KV rows, SSM/conv state, position) in
    place."""
    return slot_update(cache, _zeroed_slot(cache, slot), slot)


def _ssm_stack(params, cfg, x, positions, cache, decode: bool,
               chunked: bool = False, write_mask=None):
    """The ssm and hybrid families' layers over a cache: each layer's SSM
    state and conv state are read from the cache and the new ones written
    into it in place.  ``chunked`` (a mid-prompt prefill chunk) and
    ``decode`` continue from the cached conv inputs; a fresh prefill
    starts from zeros.  ``write_mask`` ((B,) bool) keeps a masked row's
    state as it was (paged decode: a filling slot's recurrence must
    survive the pool steps between its chunks) and sends its shared-KV
    writes to the trash block.  The hybrid's shared block g attends over
    (and writes its KV rows into) views of ``cache["shared_k"][g]`` and
    ``["shared_v"][g]``, from position 0 in a fresh prefill and from
    ``cache["pos"]`` in decode and chunks."""
    pos = cache["pos"]
    cache_pos = pos if (decode or chunked) else torch.zeros_like(pos)
    groups = _groups(cfg)
    for lo, hi, g in groups:
        for i in range(lo, hi):
            st, cx, cbc = (cache[k][i] for k in ("ssm", "conv_x",
                                                 "conv_bc"))
            x, (new_st, (new_cx, new_cbc)) = _mamba_block(
                _layer(params["layers"], i), x, cfg, ssm_state=st,
                conv_state=(cx, cbc) if (decode or chunked) else None,
                decode=decode)
            for old, new in ((st, new_st), (cx, new_cx), (cbc, new_cbc)):
                if write_mask is not None:
                    keep = write_mask.reshape(-1, *[1] * (old.dim() - 1))
                    new = torch.where(keep, new.to(old.dtype), old)
                old.copy_(new)
        if g is not None:
            x, _ = _attn_block(
                params["shared"], x, cfg, positions, False,
                kv=(cache["shared_k"][g], cache["shared_v"][g]),
                cache_pos=cache_pos, block_table=cache.get("table"),
                write_mask=write_mask, prefix="shared/",
                unrounded=hi == groups[-1][1])
    return x


def _stack(params, cfg, x, positions, cache, cache_pos, write_mask=None,
           n_prefix=0):
    tbl = cache.get("table")
    for i in range(cfg.n_layers):
        x, _ = _attn_block(_layer(params["layers"], i), x, cfg, positions,
                           cfg.layer_is_local(i),
                           kv=(cache["k"][i], cache["v"][i]),
                           cache_pos=cache_pos, block_table=tbl,
                           write_mask=write_mask, n_prefix=n_prefix)
    return x


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache: Dict,
            frontend_embs: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt, fill the cache, return last-position logits
    (B, 1, V) float32.  A vlm or audio model's ``frontend_embs`` (B, F, D)
    go ahead of the prompt (F + S cache rows; the vlm's prefix-LM mask
    over the first F)."""
    check_family(cfg)
    x, n_prefix = _embed(params, cfg, tokens, frontend_embs)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    cache = dict(cache)
    if cfg.family in RECURRENT_FAMILIES:
        x = _ssm_stack(params, cfg, x, positions, cache, decode=False)
    else:
        x = _stack(params, cfg, x, positions, cache,
                   torch.zeros((B,), dtype=torch.int32, device=x.device),
                   n_prefix=n_prefix)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    # the last position of the rounded hidden: in the reference the slice
    # stands between a hybrid's final sum and the norm, so none is fused
    last = x[:, -1:, :].to(torch_dtype(cfg.dtype))
    return _logits(params, cfg, last), cache


def prefill_into_slot(params, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: Dict, slot: int,
                      frontend_embs: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """Prefill ONE request (tokens (1, P), ``frontend_embs`` (1, F, D) as
    in ``prefill``) into pool slot ``slot``: the slot is reset, the prompt
    runs a batch-1 prefill against the slot's views, and its position is
    written back; other slots are untouched."""
    reset_slot(cache, slot)
    logits, sub = prefill(params, cfg, tokens, slot_slice(cache, slot),
                          frontend_embs)
    return logits, slot_update(cache, sub, slot)


def prefill_chunk_into_slot(params, cfg: ModelConfig, tokens: torch.Tensor,
                            cache: Dict, slot: int
                            ) -> Tuple[torch.Tensor, Dict]:
    """Advance ONE slot's prefill by one chunk (tokens (1, C)).

    The chunk starts at the slot's current ``cache["pos"]``, runs a
    batch-1 forward at absolute positions [pos, pos+C), and leaves pos at
    pos+C.  The slot is NOT reset: earlier chunks' KV rows (or a shared
    prefix's refcounted blocks) are the context this chunk attends to.
    Returns logits for ALL C chunk positions (1, C, V); every row equals
    the same row of a single-shot prefill (row-local GEMMs and a per-row
    softmax over an identical masked key stream).  The ssm and hybrid
    families carry conv and SSM state across chunks: its rows equal a
    single-shot prefill's when the chunk boundaries fall on multiples of
    ``cfg.ssm_chunk`` and the prompt is a whole number of chunks (the
    scheduler enforces the latter: a padded chunk tail would run through
    the recurrent state, where attention's validity horizon masks it)."""
    check_family(cfg)
    sub = dict(slot_slice(cache, slot))
    x, _ = _embed(params, cfg, tokens)
    B, S, _ = x.shape
    pos = sub["pos"]
    positions = pos[:, None] + torch.arange(S, device=x.device)[None, :]
    if cfg.family in RECURRENT_FAMILIES:
        x = _ssm_stack(params, cfg, x, positions, sub, decode=False,
                       chunked=True)
    else:
        x = _stack(params, cfg, x, positions, sub, pos)
    sub["pos"] = pos + S
    return _logits(params, cfg, x), slot_update(cache, sub, slot)


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: Dict,
                live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """token (B, 1) -> logits (B, 1, V); cache advanced by one position.

    Each slot decodes at its own ``cache["pos"]`` entry.  ``live`` ((B,)
    bool) freezes finished slots: their position does not advance (their
    logits are computed and discarded), and in PAGED caches their KV
    write goes to the trash block -- their table may alias blocks a live
    request reads (shared prefixes, or their own half-prefilled
    chunks), and their SSM and conv state is held (a filling slot's
    recurrence must survive the pool steps between its chunks).

    ``cache["pos"]`` is advanced in place and ``cache`` itself returned:
    every tensor of the state keeps its storage, which a captured step
    (``launch/graphs.py``) needs.  A caller that steps twice from one
    state clones ``pos`` first."""
    check_family(cfg)
    x, _ = _embed(params, cfg, token)
    pos = cache["pos"]
    wmask = live if (live is not None and is_paged(cache)) else None
    if cfg.family in RECURRENT_FAMILIES:
        x = _ssm_stack(params, cfg, x, pos[:, None], cache, decode=True,
                       write_mask=wmask)
    else:
        x = _stack(params, cfg, x, pos[:, None], cache, pos,
                   write_mask=wmask)
    pos.add_(1 if live is None else live.to(torch.int32))
    return _logits(params, cfg, x), cache


def verify_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: Dict,
                live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, S) -> logits (B, S, V): the speculative-verify forward.

    All S = k+1 positions of a draft block go through the model in ONE
    forward (every projection sees a (B*S, K) GEMM: kernel row 1 up to
    32 rows, row 2 above), writing KV rows at ``cache["pos"] + [0, S)``.
    ``cache["pos"]`` is NOT advanced: the caller commits the accepted
    prefix by setting pos, which is also the whole rollback -- rows past
    the committed pos are masked by the attention's validity horizon and
    overwritten by the next round.

    Position i's logits equal what ``decode_step`` gives after
    committing tokens[:, :i+1]: the attention is pinned to the plain
    read (decode's own S == 1 route), and every other operation is
    row-local with a per-row result that does not depend on the number
    of rows (on the card ``layers.rms_norm``, ``layers.matmul`` and
    ``layers.plain_attention`` see to that; ``tools/row_probe.py`` and
    ``tools/verify_divergence.py`` measure it).  ``live``
    matters only for paged caches: it sends non-live rows' writes to the
    trash block.  Restricted to positional-cache families: the ssm and
    hybrid families' recurrent state advances destructively and a draft
    block cannot roll it back."""
    check_family(cfg)
    check_speculative(cfg)
    if cfg.attn_impl != "plain":
        cfg = dataclasses.replace(cfg, attn_impl="plain")
    x, _ = _embed(params, cfg, tokens)
    B, S, _ = x.shape
    pos = cache["pos"]
    positions = pos[:, None] + torch.arange(S, device=x.device)[None, :]
    cache = dict(cache)
    wmask = live if (live is not None and is_paged(cache)) else None
    x = _stack(params, cfg, x, positions, cache, pos, write_mask=wmask)
    return _logits(params, cfg, x), cache
