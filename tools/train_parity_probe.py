"""Measure how far the port's training runs part from the reference's
(on the CPU) and from the port's CPU path (on a CUDA card), at smoke size.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_parity_probe.py --cpu
    PYTHONPATH=src python tools/train_parity_probe.py --card

``--cpu`` (needs JAX): 60 steps of minicpm-2b at smoke, batch 4 x seq 48
(the reference's ``test_train_loss_decreases``), through the reference's
``train``, through the port's ``train`` from the reference's ``lm.init``
weights, and through the port's ``train`` from its own (a CPU torch
generator, seed 0).  Prints each run's first and second half's mean loss
and the largest step-wise difference between the first two runs.

``--card`` (no JAX): the cases of ``tests/test_torch_cuda.py``'s
card-against-CPU training tests, with the deviations they are held to:
``lm_loss`` relative and each leaf's gradient over the leaf's largest
|g| for the five smoke configs, two AdamW updates (relative or of the
leaf's largest), and the 60-step run's largest step-wise loss difference
and halves on both devices.  Prints one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

KW = dict(smoke=True, steps=60, batch=4, seq=48, log_every=100)
LOSS_CASES = (("minicpm-2b", False), ("minicpm-2b", True),
              ("gemma2-9b", False), ("mamba2-130m", True),
              ("qwen2-moe-a2.7b", False))


def _halves(losses) -> list:
    v = np.asarray(losses, np.float64)
    return [float(v[:30].mean()), float(v[30:].mean())]


def cpu() -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch import train as jtrain
    from repro.models import lm as jlm
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import train as ttrain
    from repro_torch.models import lm as tlm
    _, _, ref = jtrain.train("minicpm-2b", **KW)
    _, _, own = ttrain.train("minicpm-2b", device="cpu", **KW)
    init = tlm.init

    def ref_init(key, cfg, device=None):
        jcfg = dataclasses.replace(jget(cfg.name, smoke=True),
                                   cim_mode=cfg.cim_mode)
        jp, _ = jlm.init(jax.random.PRNGKey(int(key)), jcfg)
        return params_from_jax(jax.tree.map(
            lambda v: np.asarray(v.astype(jnp.float32)), jp), cfg, device)
    tlm.init = ref_init
    try:
        _, _, port = ttrain.train("minicpm-2b", device="cpu", **KW)
    finally:
        tlm.init = init
    return {"reference_halves": _halves(ref),
            "port_from_reference_weights_halves": _halves(port),
            "port_vs_reference_max_abs": float(np.abs(
                np.asarray(port) - np.asarray(ref, np.float64)).max()),
            "port_own_weights_halves": _halves(own)}


def card() -> dict:
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.launch import train as ttrain
    from repro_torch.models import lm
    from repro_torch.optim import (OptConfig, adamw_update, init_opt_state,
                                   tree_leaves, tree_map)
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "lm_loss": {}}
    for arch, cim in LOSS_CASES:
        cfg = dataclasses.replace(get_config(arch, smoke=True), cim_mode=cim)
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab_size, (2, 32))).long()
        cpu_p = lm.init(0, cfg, device="cpu")
        res = []
        for params in (cpu_p, tree_map(lambda p: p.to(dev), cpu_p)):
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss = lm.lm_loss(params, cfg, toks.to(leaves[0].device))
            grads = torch.autograd.grad(loss, leaves)
            res.append((float(loss.detach()),
                        [g.float().cpu() for g in grads]))
        (want, gw), (got, gc) = res
        out["lm_loss"][f"{arch} cim={cim}"] = {
            "loss_rel": abs(got - want) / abs(want),
            "grad_over_leaf_max": max(
                float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(gc, gw))}
    rng = np.random.default_rng(6)

    def tree(scale):
        return {"a": torch.tensor(rng.standard_normal((64, 48)) * scale,
                                  dtype=torch.bfloat16),
                "b": {"c": torch.tensor(rng.standard_normal(40) * scale,
                                        dtype=torch.float32)}}
    p0, grads = tree(0.1), [tree(3.0), tree(0.05)]
    out["adamw"] = {}
    for md in ("float32", "bfloat16"):
        cfg = OptConfig(schedule="wsd", warmup=2, total_steps=10,
                        moment_dtype=md)
        res = []
        for d in ("cpu", dev):
            to = lambda t: {"a": t["a"].to(d, copy=True),
                            "b": {"c": t["b"]["c"].to(d, copy=True)}}
            p = to(p0)
            s = init_opt_state(p, cfg)
            for g in grads:
                p, s = adamw_update(p, to(g), s, cfg)
            res.append([t.cpu().float() for t in tree_leaves(p)
                        + tree_leaves(s["m"]) + tree_leaves(s["v"])])
        out["adamw"][md] = [
            float(((g - w).abs() / torch.maximum(
                w.abs(), w.abs().max())).max())
            for w, g in zip(*res)]
    init = lm.init

    def cpu_init(key, cfg, device=None):
        return tree_map(lambda p: p.to(resolve_device(device)),
                        init(key, cfg, device="cpu"))
    lm.init = cpu_init
    try:
        _, _, on_cpu = ttrain.train("minicpm-2b", device="cpu", **KW)
        _, _, on_card = ttrain.train("minicpm-2b", device=dev, **KW)
    finally:
        lm.init = init
    out["train_60"] = {
        "max_abs": float(np.abs(np.asarray(on_card)
                                - np.asarray(on_cpu)).max()),
        "cpu_halves": _halves(on_cpu), "card_halves": _halves(on_card)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--cpu", action="store_true")
    g.add_argument("--card", action="store_true")
    args = ap.parse_args()
    print(json.dumps(cpu() if args.cpu else card()))


if __name__ == "__main__":
    main()
