"""Lock-step serving driver.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b \
      [--smoke] [--cim] [--no-fuse] [--batch 4] \
      [--prompt-len 32] [--gen 16] [--device cuda]

Counterpart of ``repro/launch/serve.py::serve``: one fixed batch is
prefilled together and decodes greedily in lock step for exactly ``gen``
tokens.  Under ``--cim`` every projection is packed once
(``lm.pack_cim_params``; unpacked per-call conditioning is not ported)
and each macro GEMM runs through the CUDA kernels on the card (their
plain version on the CPU).  Runs on CUDA
unless ``--device cpu`` is given; without ``--smoke`` it serves the full
width and depth of the arch.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import ARCHS, get_config
from ..data import DataConfig, batch_at
from ..models import lm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, smoke: bool = True, batch: int = 4, prompt_len: int = 32,
          gen: int = 16, cim: bool = False, temperature: float = 0.0,
          seed: int = 0, return_stats: bool = False,
          fuse: bool = True, device=None, params=None,
          use_kernel=None):
    """Returns the generated tokens (batch, gen) as int32 numpy; with
    ``return_stats=True``, (tokens, stats).

    ``params`` injects float params (the reference's ``lm.init`` tree,
    e.g. through ``convert.params_from_jax``) instead of a fresh random
    init from ``seed``.  ``use_kernel`` sets ``cfg.cim_use_kernel``
    (False: the kernels' plain version, for comparison runs).  Stats
    hold ``pack_s``, ``prefill_s``, ``decode_s`` and ``decode_tok_s``,
    each phase timed between device synchronizations, and the last
    step's logits."""
    if temperature > 0:
        raise NotImplementedError(
            "sampling at temperature > 0 waits on jax.random parity; the "
            "torch driver is greedy only")
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if not fuse:
        cfg = dataclasses.replace(cfg, cim_fuse=False)
    if cim:
        cfg = dataclasses.replace(cfg, cim_mode=True,
                                  cim_use_kernel=use_kernel)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=prompt_len,
                      global_batch=batch, seed=seed, d_model=cfg.d_model)
    with torch.inference_mode():
        if params is None:
            params = lm.init(seed, cfg, device=dev)
        else:
            params = lm._to_device(params, dev)
        tokens = torch.from_numpy(batch_at(dcfg, 0)["tokens"]).to(
            dev, torch.int64)

        _sync(dev)
        t0 = time.perf_counter()
        if cim:
            params = lm.pack_cim_params(params, cfg, dev)
        _sync(dev)
        t_pack = time.perf_counter() - t0

        cache = lm.init_cache(cfg, batch, prompt_len + gen, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, cfg, tokens, cache)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        out = [tok]                   # on the device; one copy at the end
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, cache = lm.decode_step(params, cfg, tok, cache)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(tok)
        gen_tokens = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
        _sync(dev)
        t_decode = time.perf_counter() - t0

    steps = gen - 1
    decode_tok_s = (batch * steps / t_decode if steps and t_decode > 0
                    else float("nan"))
    stats = dict(arch=arch, smoke=smoke, n_layers=cfg.n_layers, batch=batch,
                 prompt_len=prompt_len, gen=gen, cim=cim,
                 fused=cim and cfg.cim_fuse, device=str(dev),
                 pack_s=t_pack, prefill_s=t_prefill, decode_s=t_decode,
                 decode_tok_s=decode_tok_s,
                 prefill_tok_s=batch * prompt_len / t_prefill,
                 last_logits=logits[:, -1].float().cpu())
    mode = "cim-packed" if cim else "fp"
    print(f"[serve] {arch} ({mode}, {dev}): batch {batch}, prompt "
          f"{prompt_len}, gen {gen} | pack {t_pack:.3f}s, prefill "
          f"{t_prefill:.3f}s, decode {t_decode:.3f}s "
          f"({decode_tok_s:.1f} tok/s)")
    if return_stats:
        return gen_tokens, stats
    return gen_tokens


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config (default: full)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cim", action="store_true")
    ap.add_argument("--no-fuse", dest="fuse", action="store_false")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain reference path)")
    args = ap.parse_args()
    toks = serve(args.arch, smoke=args.smoke, batch=args.batch,
                 prompt_len=args.prompt_len, gen=args.gen, cim=args.cim,
                 seed=args.seed, fuse=args.fuse,
                 device=args.device)
    print(np.array2string(toks, max_line_width=120))


if __name__ == "__main__":
    main()
