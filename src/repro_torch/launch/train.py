"""End-to-end training driver with fault tolerance.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
      [--smoke | --full] --steps 50 [--ckpt-dir DIR] [--resume] \
      [--fail-at 20] [--cim] [--device cpu]

Counterpart of ``repro/launch/train.py``:
  * deterministic step-indexed data (``data.batch_at``; skip-ahead on
    resume),
  * atomic checkpoints + keep-last-k + resume-from-latest
    (``checkpoint``, the reference's format),
  * failure injection (``--fail-at``) to prove restart-correctness,
  * WSD or cosine schedule per the arch config (``optim``),
  * CIM execution mode (``--cim``): every raw projection through the
    emulated macro, quantized per call (kernel row 6 on the card), with
    straight-through-estimator gradients (``core.qat``).
Each layer and each CE chunk is recomputed in the backward
(``torch.utils.checkpoint``), so the macro forward runs twice a step.
It runs on CUDA unless ``--device cpu`` is given, and fails without a
card rather than falling back to the CPU.  Weights come from ``lm.init``
with a torch generator seeded by ``seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import checkpoint as ckpt
from .. import resolve_device
from ..configs import ARCHS, get_config
from ..data import DataConfig, batch_at
from ..models import lm
from ..optim import init_opt_state
from .specs import make_train_step


def train(arch: str, smoke: bool = True, steps: int = 50,
          ckpt_dir: str = "", resume: bool = False, fail_at: int = -1,
          ckpt_every: int = 10, batch: int = 8, seq: int = 64,
          cim: bool = False, log_every: int = 10, seed: int = 0,
          device=None):
    """Returns (params, opt_state, losses), the losses of the steps run
    here as Python floats."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if cim:
        cfg = dataclasses.replace(cfg, cim_mode=True)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=seed,
                      n_frontend_tokens=cfg.n_frontend_tokens
                      if cfg.family == "vlm" else 0,
                      d_model=cfg.d_model)
    step_fn, ocfg = make_train_step(cfg)
    ocfg = dataclasses.replace(ocfg, total_steps=steps,
                               warmup=max(1, steps // 10))

    params = lm.init(seed, cfg, device=dev)
    opt_state = init_opt_state(params, ocfg)
    start = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state = ckpt.restore(ckpt_dir, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start = ckpt.load_meta(ckpt_dir)["step"]
        print(f"[train] resumed from step {start}")

    losses = []
    for step in range(start, steps):
        if step == fail_at:
            raise RuntimeError(f"injected failure at step {step}")
        b = batch_at(dcfg, step)
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if "frontend_embs" in b:
            b["frontend_embs"] = b["frontend_embs"].to(torch.bfloat16)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({time.time()-t0:.2f}s)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1,
                      {"params": params, "opt": opt_state},
                      meta={"arch": arch, "loss": loss})
    return params, opt_state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--cim", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain reference path)")
    args = ap.parse_args()
    train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
          seq=args.seq, ckpt_dir=args.ckpt_dir, resume=args.resume,
          fail_at=args.fail_at, cim=args.cim, device=args.device)


if __name__ == "__main__":
    main()
