"""Serving drivers: lock-step and continuous batching.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b \
      [--smoke] [--cim] [--no-fuse] [--batch 4] \
      [--prompt-len 32] [--gen 16] [--device cuda] \
      [--continuous [--requests 8] [--paged-blocks N [--block-size 16]
       [--prefill-chunk C] [--no-prefix-sharing]]]

Counterpart of ``repro/launch/serve.py``.  ``serve`` prefills one fixed
batch together and decodes greedily in lock step for exactly ``gen``
tokens.  ``serve_continuous`` (``--continuous``) serves a mixed-length
request queue from a fixed pool of ``--batch`` slots through
``launch/scheduler.py``, with a contiguous KV cache or, under
``--paged-blocks``, a paged one (chunked prefill, shared prefixes, and
the paged-attention kernel for decode reads).  Under ``--cim`` every
projection is packed once (``lm.pack_cim_params``; unpacked per-call
conditioning is not ported) and each macro GEMM runs through the CUDA
kernels on the card (their plain version on the CPU).  Runs on CUDA
unless ``--device cpu`` is given; without ``--smoke`` it serves the full
width and depth of the arch.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs import ARCHS, get_config
from ..data import DataConfig, batch_at
from ..models import lm
from .paging import PagedLayout, cdiv
from .scheduler import ContinuousBatchingScheduler, mixed_length_requests


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


def serve_continuous(arch: str, smoke: bool = True, slots: int = 2,
                     prompt_len: int = 16, n_requests: int = 8,
                     stop_lengths=(4, 16, 8, 12), cim: bool = False,
                     temperature: float = 0.0, seed: int = 0,
                     compare_lockstep: bool = True, fuse: bool = True,
                     draft_k: int = 0, paged: Optional[PagedLayout] = None,
                     prefill_chunk: Optional[int] = None,
                     prefix_sharing: bool = True, metrics: bool = False,
                     device=None, params=None):
    """Continuous-batching driver: a mixed-length request queue served
    from a fixed pool of ``slots`` decode slots (launch/scheduler.py).

    Returns (tokens_by_rid, stats).  With ``compare_lockstep=True`` the
    same requests also run through the lock-step wave baseline on the
    same pool (contiguous mode) and the per-request tokens are asserted
    equal -- the scheduler may only reorder work, never change it; a
    paged run is compared with the contiguous scheduler instead.
    ``params`` injects float params instead of a fresh init from
    ``seed``.  Speculative rounds, telemetry and sampling are not ported
    yet and raise."""
    if temperature > 0:
        raise NotImplementedError(
            "sampling at temperature > 0 waits on jax.random parity; the "
            "torch driver is greedy only")
    if draft_k:
        raise NotImplementedError("speculative rounds are not ported yet")
    if metrics:
        raise NotImplementedError("telemetry is not ported yet")
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if not fuse:
        cfg = dataclasses.replace(cfg, cim_fuse=False)
    if cim:
        cfg = dataclasses.replace(cfg, cim_mode=True)
    requests = mixed_length_requests(n_requests, prompt_len, cfg.vocab_size,
                                     stop_lengths=stop_lengths, seed=seed)
    cap = max(stop_lengths)
    with torch.inference_mode():
        params = (lm.init(seed, cfg, device=dev) if params is None
                  else lm._to_device(params, dev))
        _sync(dev)
        t0 = time.perf_counter()
        if cim:
            params = lm.pack_cim_params(params, cfg, dev)
        _sync(dev)
        t_pack = time.perf_counter() - t0
    sched = ContinuousBatchingScheduler(
        params, cfg, slots=slots, prompt_len=prompt_len, max_new_cap=cap,
        paged=paged, prefill_chunk=prefill_chunk,
        prefix_sharing=prefix_sharing)
    report = sched.run(requests)
    want = report.tokens_by_rid()
    stats = dict(arch=arch, n_layers=cfg.n_layers, slots=slots,
                 prompt_len=prompt_len, n_requests=n_requests, cim=cim,
                 device=str(dev), pack_s=round(t_pack, 4),
                 continuous=report.summary(), n_iter=report.n_iter,
                 host_syncs=report.host_syncs,
                 host_syncs_per_iter=report.host_syncs / max(report.n_iter, 1),
                 iter_ms=1e3 * report.wall_s / max(report.n_iter, 1),
                 branch_counts=report.branch_counts,
                 branch_ms_per_iter={
                     b: 1e3 * t / report.branch_counts[b]
                     for b, t in report.branch_s.items()
                     if report.branch_counts[b]})
    if paged is not None:
        drained = report.ref_final.tolist() == [1] + [0] * (paged.n_blocks - 1)
        stats["paged"] = dict(
            block_size=paged.block_size, n_tbl=paged.n_tbl,
            n_blocks=paged.n_blocks, prefill_chunk=sched.prefill_chunk,
            prefix_sharing=prefix_sharing, peak_blocks=report.peak_blocks,
            kv_bytes_peak=sched.kv_bytes_paged(report.peak_blocks),
            kv_bytes_contiguous=sched.kv_bytes_contiguous(),
            refcounts_drained=drained,
            prefix_plan=sched.last_prefix_plan.stats())
        if compare_lockstep:
            # the paged pool may only change WHERE KV rows live; the
            # contiguous scheduler reads them with the plain attention, so
            # tokens are asserted equal only where the paged read is the
            # plain version too (the kernel's float32 P.V can move a bf16
            # activation by one ulp, and in CIM mode an ADC code with it)
            ref = ContinuousBatchingScheduler(
                params, cfg, slots=slots, prompt_len=prompt_len,
                max_new_cap=cap).run(requests).tokens_by_rid()
            same = [np.array_equal(want[rid], ref[rid]) for rid in ref]
            stats["tokens_equal_contiguous_share"] = sum(same) / len(same)
            if dev.type != "cuda":
                for rid in ref:
                    np.testing.assert_array_equal(
                        want[rid], ref[rid],
                        err_msg=f"request {rid}: paged KV changed tokens vs "
                                "the contiguous scheduler")
                stats["tokens_match_contiguous"] = True
    elif compare_lockstep:
        base = sched.run_lockstep(requests)
        for rid, toks in base.tokens_by_rid().items():
            np.testing.assert_array_equal(
                want[rid], toks,
                err_msg=f"request {rid}: continuous batching changed tokens "
                        "vs the lock-step baseline")
        stats["lockstep"] = base.summary()
        stats["tokens_match_lockstep"] = True
        stats["speedup_vs_lockstep"] = round(report.tok_s / base.tok_s, 2)
    mode = "cim-packed" if cim else "fp"
    if paged is not None:
        mode += f"+paged-bs{paged.block_size}"
    line = (f"[serve-cb] {arch} ({mode}, {dev}): {n_requests} reqs over "
            f"{slots} slots | {report.tok_s:.1f} tok/s, occupancy "
            f"{report.occupancy:.0%}, {stats['iter_ms']:.1f} ms/iteration")
    if "lockstep" in stats:
        line += (f" | lock-step {stats['lockstep']['tok_s']:.1f} tok/s "
                 f"({stats['speedup_vs_lockstep']:.2f}x, tokens identical)")
    print(line)
    return want, stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config (default: full)")
    ap.add_argument("--batch", type=int, default=4,
                    help="lock-step batch / continuous slot count")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cim", action="store_true")
    ap.add_argument("--no-fuse", dest="fuse", action="store_false")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a mixed-length queue")
    ap.add_argument("--requests", type=int, default=8,
                    help="(--continuous) queued request count")
    ap.add_argument("--paged-blocks", type=int, default=0,
                    help="(--continuous) KV pool size in blocks; 0 keeps "
                         "the contiguous per-slot layout")
    ap.add_argument("--block-size", type=int, default=16,
                    help="(--paged-blocks) tokens per KV block")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="(--paged-blocks) prompt tokens prefilled per "
                         "scheduler iteration (default: whole prompt)")
    ap.add_argument("--no-prefix-sharing", dest="prefix_sharing",
                    action="store_false",
                    help="(--paged-blocks) disable shared-prefix reuse")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain reference path)")
    args = ap.parse_args()
    if args.continuous:
        paged = None
        if args.paged_blocks:
            # the default workload's longest budget is 16 tokens
            paged = PagedLayout(
                block_size=args.block_size,
                n_tbl=cdiv(args.prompt_len + 16, args.block_size),
                n_blocks=args.paged_blocks)
        toks, _ = serve_continuous(
            args.arch, smoke=args.smoke, slots=args.batch,
            prompt_len=args.prompt_len, n_requests=args.requests,
            cim=args.cim, seed=args.seed, fuse=args.fuse, paged=paged,
            prefill_chunk=args.prefill_chunk,
            prefix_sharing=args.prefix_sharing, device=args.device)
        for rid in sorted(toks):
            print(rid, toks[rid].tolist())
        return
    toks = serve(args.arch, smoke=args.smoke, batch=args.batch,
                 prompt_len=args.prompt_len, gen=args.gen, cim=args.cim,
                 seed=args.seed, fuse=args.fuse,
                 device=args.device)
    print(np.array2string(toks, max_line_width=120))


if __name__ == "__main__":
    main()
