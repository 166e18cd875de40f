"""AdamW with global-norm clipping, configurable moment dtypes, decoupled
weight decay and grad-accumulation support, over nested dicts of
tensors.

Counterpart of ``repro/optim/adamw.py``: the update math is float32
whatever the storage dtypes, in the reference's order, and the moments
are bfloat16 where ``moment_dtype`` says so (the 64-expert-and-up
configs).  ``adamw_update`` writes the new parameters and moments into
the given tensors, as the reference's jitted step donates its buffers:
at full width a second copy of parameters and moments would not fit
beside the gradients; a large leaf is updated in row blocks.  Trees flatten in jax's order (sorted dict keys),
so the global norm sums the leaves as the reference's ``tree.reduce``
does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..core import prng
from ..models.lm import torch_dtype
from .schedules import make_schedule


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"           # "cosine" | "wsd"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # "bfloat16" halves optimizer memory
    accum_steps: int = 1


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict in jax's flatten order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """A nested dict shaped like ``tree`` holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees shaped like it."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    mdt = torch_dtype(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    dev = tree_leaves(params)[0].device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "m": tree_map(zeros, params), "v": tree_map(zeros, params)}
    if cfg.accum_steps > 1:
        state["accum"] = tree_map(zeros, params)
        state["micro"] = torch.zeros((), dtype=torch.int32, device=dev)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the leaves' float32 sums of squares, added in leaf order."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.square(g.to(torch.float32)).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig
                 ) -> Tuple[Any, Dict[str, Any]]:
    """One optimizer step, in place.  Returns (params, new state): the
    same parameter and moment tensors, updated, and the advanced step."""
    sched = make_schedule(cfg.schedule, peak_lr=cfg.peak_lr,
                          warmup=cfg.warmup, total=cfg.total_steps)
    step = state["step"] + 1
    n = int(step)
    lr = sched(n)

    gn = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gn, 1e-9), 1.0)

    b1, b2 = cfg.b1, cfg.b2
    f32 = np.float32
    bc1 = float(f32(1.0) - np.power(f32(b1), f32(n)))
    bc2 = float(f32(1.0) - np.power(f32(b2), f32(n)))
    mdt = torch_dtype(cfg.moment_dtype)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mh, vh = m32 / bc1, v32 / bc2
        p32 = p.to(torch.float32)
        root = torch.sqrt(vh) if vh.is_cuda else prng.sqrt(vh)
        delta = mh / (root + cfg.eps) + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
        m.copy_(m32.to(mdt))
        v.copy_(v32.to(mdt))

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        for rows in _row_blocks(p):
            upd(p[rows], g[rows], m[rows], v[rows])
    return params, dict(state, step=step)


# elements per piece of a leaf's update: the update is elementwise, so a
# stacked leaf (40 x 2,304 x 5,760 at full width) goes through in row
# blocks, and its float32 temporaries stay ~0.1 GB each
_UPDATE_BLOCK = 1 << 25


def _row_blocks(p: torch.Tensor) -> list:
    if p.dim() == 0 or p.numel() <= _UPDATE_BLOCK:
        return [slice(None)]
    step = max(1, _UPDATE_BLOCK // (p.numel() // p.shape[0]))
    return [slice(i, i + step) for i in range(0, p.shape[0], step)]


def accumulate_grads(state, grads, cfg: OptConfig):
    """Error-free micro-batch accumulation (for grad-accum training)."""
    mdt = torch_dtype(cfg.moment_dtype)
    acc = tree_map(lambda a, g: (a.to(torch.float32)
                                 + g.to(torch.float32)).to(mdt),
                   state["accum"], grads)
    return dict(state, accum=acc, micro=state["micro"] + 1)
