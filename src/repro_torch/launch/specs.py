"""Step functions and shape bookkeeping of the train / serve launchers.

Counterpart of ``repro/launch/specs.py``'s device-independent part:
``SHAPES`` (the four assigned LM shapes), ``applicable``,
``param_count``, ``active_param_count`` and the step builders
``make_train_step``, ``make_prefill_step`` and ``make_decode_step``.
The mesh and sharding part (``batch_specs``, ``cache_specs``,
``build_cell``, ``CellSpec``) waits for the port's multi-device work.

    train_4k      seq 4096,   global_batch 256   -> train_step
    prefill_32k   seq 32768,  global_batch 32    -> prefill (serve)
    decode_32k    seq 32768,  global_batch 128   -> serve_step (1 new token)
    long_500k     seq 524288, global_batch 1     -> serve_step; SSM/hybrid only
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..optim import OptConfig, adamw_update, tree_leaves, tree_unflatten

SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic context handling: SSM/hybrid only."""
    if shape_name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, (
            f"{cfg.name} is a full-attention decoder; 500k-token context "
            "requires sub-quadratic attention (run for SSM/hybrid only). "
            "Skip recorded per DESIGN.md §4.")
    return True, ""


def param_count(params) -> int:
    """Elements over the leaves of a params tree (anything with .shape)."""
    n = 0
    for leaf in tree_leaves(params):
        k = 1
        for d in leaf.shape:
            k *= int(d)
        n += k
    return n


def active_param_count(cfg: ModelConfig, params) -> int:
    """MoE: only top_k routed experts (+everything else) are active/token."""
    total = param_count(params)
    if not cfg.n_experts:
        return total
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total - inactive


def make_train_step(cfg: ModelConfig, ocfg: Optional[OptConfig] = None):
    """(train_step, ocfg): WSD or cosine per the config, bf16 moments at
    64 experts and up.  ``train_step(params, opt_state, batch)`` takes the
    loss, its gradients over every parameter leaf
    (``torch.autograd.grad``; a leaf the loss does not reach gets zeros,
    as jax's gradient gives it) and one AdamW update in place; returns
    (params, opt_state, {"loss": 0-d float32})."""
    ocfg = ocfg or OptConfig(
        schedule=cfg.lr_schedule if cfg.lr_schedule in ("wsd", "cosine")
        else "cosine",
        moment_dtype="bfloat16" if cfg.n_experts >= 64 else "float32",
    )

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = lm.lm_loss(params, cfg, batch["tokens"],
                          batch.get("frontend_embs"))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        params, opt_state = adamw_update(
            params, tree_unflatten(params, grads), opt_state, ocfg)
        return params, opt_state, {"loss": loss.detach()}

    return train_step, ocfg


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, cache):
        return lm.prefill(params, cfg, batch["tokens"], cache,
                          batch.get("frontend_embs"))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, batch, cache):
        return lm.decode_step(params, cfg, batch["token"], cache)
    return serve_step
