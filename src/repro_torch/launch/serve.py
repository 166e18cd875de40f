"""Serving drivers: lock-step, speculative and continuous batching.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b \
      [--smoke] [--cim [--no-pack]] [--no-fuse] [--batch 4] \
      [--prompt-len 32] [--gen 16] [--device cuda] [--no-graphs] \
      [--temperature T] [--noise-seed S] \
      [--speculative [--draft-k 8] [--draft-adc-bits B]
       [--adaptive-draft-k]] \
      [--continuous [--requests 8] [--paged-blocks N [--block-size 16]
       [--prefill-chunk C] [--no-prefix-sharing]]] \
      [--watchdog] [--inject-fault SPEC] [--segment-iters 8] \
      [--metrics] [--metrics-out PATH] [--trace-out PATH]

Counterpart of ``repro/launch/serve.py``.  ``serve`` prefills one fixed
batch together and decodes in lock step for exactly ``gen`` tokens,
greedily or, at ``--temperature`` > 0, sampling every token (the first
included) from ``scheduler.sampling_key(seed)`` through ``core/prng.py``,
the reference's threefry streams bit for bit.  ``serve_speculative``
(``--speculative``) decodes the same batch by plan-cascade speculative
rounds: the all-analog shadow of the serving plan drafts ``draft_k``
tokens from the same pack, one verify forward over all k+1 positions
checks them, and the longest agreeing prefix plus a correction is kept
-- greedy tokens equal ``serve``'s; at temperature the round is
rejection sampling, equal to the reference's round for round.
``--noise-seed`` (``noise_seed=``, CIM only) adds the macro's analog
noise to every conversion, one stream per projection; the noisy GEMMs
run the chunked fast GEMM in torch, not the noise-free kernels, as the
reference's leave its Pallas kernels.
``serve_continuous`` (``--continuous``) serves a mixed-length request
queue from a fixed pool of ``--batch`` slots through
``launch/scheduler.py``, with a contiguous KV cache or, under
``--paged-blocks``, a paged one (chunked prefill, shared prefixes, and
the paged-attention kernel for decode reads), speculative rounds under
``--speculative``.  Under ``--cim`` every projection is packed once
(``lm.pack_cim_params``) and each macro GEMM runs through the CUDA
kernels on the card (their plain version on the CPU); lock-step
``--no-pack`` (``serve(pack=False)``) serves the raw weights instead,
quantizing them at every call (the unpacked kernel, row 6, at the
prototype's numerics; a pack made for the call elsewhere), with tokens
equal to packed serving's; ``plan=`` (a ``repro_torch.plan``
``DeploymentPlan``) serves each projection under its own design point
and implies it.  On a CUDA device the decode step, the speculative round
and the scheduler's pooled step replay CUDA graphs captured at their
first call (``launch/graphs.py``), the counterpart of the reference's
compiled executables; ``--no-graphs`` (``graphs=False``) runs them
eagerly, and the CPU always does.  Runs on CUDA unless ``--device cpu``
is given; without ``--smoke`` it serves the full width and depth of the
arch.

``serve_guarded`` (``--watchdog``; ``--inject-fault SPEC`` implies it)
serves the continuous queue through ``resilience.failover.GuardedServer``:
one scheduler per rung of the analog -> hybrid -> digital ladder over
one pack, all on one pool state, in segments of ``--segment-iters``
loop iterations with the drift watchdog and the golden probe read at
each boundary; ``SPEC`` (``FaultModel.parse``, e.g.
``gain_amp=0.6,offset_lsb=2,schedule=ramp,onset=4,period=16``) arms
seeded analog drift on the loop's device clock.

Telemetry (``obs/``).  Every driver records the spans ``serve.pack``,
``serve.compile`` (the kernel build before the first forward and, when
captured, the first step's graph capture, a span inside the decode
span), ``serve.prefill`` and ``serve.decode`` (``serve.workload`` for
the scheduler's run) through the obs tracer (``--trace-out`` appends
them as JSON lines).  ``metrics=True`` (``--metrics``) also publishes
the run's totals into ``obs.REGISTRY`` and returns its snapshot in
``stats["metrics"]`` and the spans in ``stats["spans"]``;
``serve_continuous(metrics=True or an ObsConfig)`` serves with the
scheduler's device rings and returns their snapshot in
``stats["telemetry"]``.  ``--metrics-out PATH`` writes the registry's
Prometheus text exposition there.  The tokens are the same with metrics
on and off.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..configs import ARCHS, get_config
from ..core import prng
from ..data import DataConfig, batch_at
from ..models import lm
from ..obs import REGISTRY, ObsConfig, get_tracer, set_trace_path, span
from ..plan import draft_plan_for_model
from .graphs import StepGraph, use_graphs
from .paging import PagedLayout, cdiv
from .scheduler import (ContinuousBatchingScheduler, greedy_accept,
                        mixed_length_requests, place_correction,
                        rejection_accept, sample_rows, sampling_key)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_kernels(device: torch.device, cim: bool) -> None:
    """The kernel build, under the ``serve.compile`` span (nvcc at first
    use; loading the libraries after): only CIM serving on a CUDA
    device launches kernels."""
    if cim and device.type == "cuda":
        from ..kernels import build
        build.load_all()


def _first_call(fn, captured: bool):
    """``fn()``: a captured body's first call (a real step, then its
    graph capture) under a ``serve.compile`` span."""
    if not captured:
        return fn()
    with span("serve.compile", graph=True):
        return fn()


def _model_config(arch: str, smoke: bool, cim: bool, plan, fuse: bool,
                  use_kernel=None, noise_seed: Optional[int] = None):
    """(cfg, cim): the arch's config under the serving options; a plan
    implies CIM, and analog noise needs it."""
    cfg = get_config(arch, smoke=smoke)
    if plan is not None:
        cim = True
        cfg = dataclasses.replace(cfg, cim_plan=plan)
    if not fuse:
        cfg = dataclasses.replace(cfg, cim_fuse=False)
    if noise_seed is not None:
        if not cim:
            raise ValueError(
                "noise_seed emulates the macro's analog noise and needs "
                "cim=True (or a plan); without it serving would silently "
                "run noise-free")
        cfg = dataclasses.replace(cfg, cim_noise_seed=noise_seed)
    if cim:
        cfg = dataclasses.replace(cfg, cim_mode=True,
                                  cim_use_kernel=use_kernel)
    return cfg, cim


def _next_subkey(key: torch.Tensor) -> torch.Tensor:
    """``key, sub = split(key)``: ``key`` is advanced in place (static
    state of a captured body) and the subkey returned."""
    ks = prng.split(key)
    key.copy_(ks[0])
    return ks[1]


def lockstep_sample(logits: torch.Tensor, key: Optional[torch.Tensor],
                    temperature: float) -> torch.Tensor:
    """The lock-step driver's sampler, (B, V) -> (B, 1): the argmax at
    temperature 0, else one split of ``key`` and one categorical draw
    over the batch of the logits divided by T -- a true division, as the
    reference's sampler runs op by op (a 0-d tensor divisor keeps CUDA
    from multiplying by a reciprocal instead)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)[:, None]
    t = torch.full((), temperature, dtype=torch.float32,
                   device=logits.device)
    return prng.categorical(_next_subkey(key), logits / t)[:, None]


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a params tree (packed leaves included)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if dataclasses.is_dataclass(tree):
        return sum(tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


def serve(arch: str, smoke: bool = True, batch: int = 4, prompt_len: int = 32,
          gen: int = 16, cim: bool = False, temperature: float = 0.0,
          seed: int = 0, return_stats: bool = False,
          fuse: bool = True, device=None, params=None,
          use_kernel=None, plan=None, graphs: Optional[bool] = None,
          noise_seed: Optional[int] = None, pack: bool = True,
          metrics: bool = False):
    """Returns the generated tokens (batch, gen) as int32 numpy; with
    ``return_stats=True``, (tokens, stats).

    ``metrics=True`` publishes the run's totals into ``obs.REGISTRY``
    (tokens, decode tok/s, the mean decode-step seconds) and returns its
    snapshot as ``stats["metrics"]`` and the recorded spans as
    ``stats["spans"]``; the lock-step driver has no device rings.

    Under CIM the projections are packed once (``pack``, the default) or,
    with ``pack=False``, served from the raw weights, which every macro
    GEMM quantizes itself (inside the captured step too); the tokens are
    the same either way, with and without ``noise_seed``.

    Each decode step is one body that writes the next token into a
    static tensor and its column of the output on the device.  With
    ``graphs`` (default: on a CUDA device) the first step runs eagerly
    and is captured (``launch/graphs.py``), and the later steps replay
    the graph; ``graphs=False`` runs every step eagerly.  Prefill runs
    once and stays eager.  A vlm model (paligemma) prefills the data
    pipeline's frontend embeddings ahead of each prompt under its
    prefix-LM mask, as the reference's driver does: the cache holds
    prompt, generated and frontend tokens, and ``prefill_tok_s`` counts
    the frontend tokens.

    ``params`` injects float params (the reference's ``lm.init`` tree,
    e.g. through ``convert.params_from_jax``) instead of a fresh random
    init from ``seed``.  ``use_kernel`` sets ``cfg.cim_use_kernel``
    (False: the kernels' plain version, for comparison runs).  ``plan``
    (a ``repro_torch.plan.DeploymentPlan``) serves each projection under
    its own macro config and fidelity (implies cim).  ``temperature`` > 0
    samples every token, the first included, from
    ``sampling_key(seed)``, one split a token (the key is state the
    captured step advances); ``noise_seed`` turns on the macro's analog
    noise (``cfg.cim_noise_seed``; needs cim).  Stats hold
    ``pack_s``, ``prefill_s``, ``decode_s`` and ``decode_tok_s``, each
    phase timed between device synchronizations, ``pack_bytes``, the
    last step's logits and, when captured, ``capture_s``,
    ``graph_pool_bytes`` and ``replay_tok_s`` (the replayed steps alone)."""
    dev = resolve_device(device)
    captured = use_graphs(graphs, dev)
    if metrics:
        get_tracer().drain()        # stats["spans"]: this call's spans
    cfg, cim = _model_config(arch, smoke, cim, plan, fuse, use_kernel,
                             noise_seed)
    pack = pack and cim
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=prompt_len,
                      global_batch=batch, seed=seed,
                      n_frontend_tokens=cfg.n_frontend_tokens
                      if cfg.family == "vlm" else 0,
                      d_model=cfg.d_model)
    with torch.inference_mode():
        made = params is None       # params this call owns: packed in place
        if made:
            params = lm.init(seed, cfg, device=dev)
        else:
            params = lm._to_device(params, dev)
        b = batch_at(dcfg, 0)
        tokens = torch.from_numpy(b["tokens"]).to(dev, torch.int64)
        # a vlm's frontend embeddings (the stub's), bf16 ahead of the prompt
        fe = (torch.from_numpy(b["frontend_embs"]).to(dev, torch.bfloat16)
              if "frontend_embs" in b else None)
        n_frontend = fe.shape[1] if fe is not None else 0

        _sync(dev)
        t0 = time.perf_counter()
        if pack:
            with span("serve.pack", arch=arch):
                params = lm.pack_cim_params(params, cfg, dev, consume=made)
                _sync(dev)
        t_pack = time.perf_counter() - t0
        pack_bytes = tree_bytes(params)

        with span("serve.compile", arch=arch):
            _build_kernels(dev, cim)
        cache = lm.init_cache(cfg, batch, prompt_len + gen + n_frontend,
                              device=dev)
        # sampling draws from its own stream, not the params-init one
        key = sampling_key(seed, dev) if temperature > 0 else None
        _sync(dev)
        t0 = time.perf_counter()
        with span("serve.prefill", arch=arch):
            logits, cache = lm.prefill(params, cfg, tokens, cache, fe)
            tok = lockstep_sample(logits[:, -1], key, temperature)
            _sync(dev)
        t_prefill = time.perf_counter() - t0

        # the step's static state: the token, the output and the column
        # the next token goes to, all on the device; one copy at the end
        out = torch.zeros((batch, gen), dtype=torch.int64, device=dev)
        out[:, :1] = tok
        col = torch.ones((1, 1), dtype=torch.int64, device=dev)
        body = decode_body(params, cfg, tok, cache, out, col, temperature,
                           key)
        step = StepGraph(body, dev) if captured else body
        t0 = time.perf_counter()
        with span("serve.decode", arch=arch, steps=gen - 1):
            for i in range(gen - 1):
                if i == 1 and captured:
                    _sync(dev)
                    t_replay0 = time.perf_counter()
                logits = _first_call(step, captured) if i == 0 else step()
            _sync(dev)
            t_end = time.perf_counter()
            gen_tokens = out.to(torch.int32).cpu().numpy()
        t_decode = time.perf_counter() - t0

    steps = gen - 1
    decode_tok_s = (batch * steps / t_decode if steps and t_decode > 0
                    else float("nan"))
    stats = dict(arch=arch, smoke=smoke, n_layers=cfg.n_layers, batch=batch,
                 prompt_len=prompt_len, gen=gen, cim=cim, packed=pack,
                 fused=cim and cfg.cim_fuse, device=str(dev),
                 temperature=temperature, noise_seed=noise_seed,
                 plan=None if plan is None else plan.summary(),
                 pack_s=t_pack, pack_bytes=pack_bytes,
                 prefill_s=t_prefill, decode_s=t_decode,
                 decode_tok_s=decode_tok_s,
                 # the prefill runs the frontend tokens too
                 prefill_tok_s=batch * (prompt_len + n_frontend) / t_prefill,
                 n_frontend=n_frontend,
                 graphs=captured, last_logits=logits[:, -1].float().cpu())
    if captured and gen > 2:
        stats.update(capture_s=step.capture_s,
                     graph_pool_bytes=step.pool_bytes,
                     replay_tok_s=batch * (gen - 2) / (t_end - t_replay0))
    if metrics:
        REGISTRY.counter(
            "serve_tokens_total",
            "tokens emitted by the serving drivers").inc(batch * gen)
        REGISTRY.gauge("serve_decode_tok_s",
                       "lock-step decode throughput").set(decode_tok_s)
        REGISTRY.histogram(
            "serve_decode_step_seconds", "mean decode-step latency",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0)).observe_many(
            [t_decode / steps] * steps if steps else [])
        stats["metrics"] = REGISTRY.snapshot()
        stats["spans"] = get_tracer().drain()
    mode = ("cim-" + ("packed" if pack else "unpacked")
            + ("-planned" if plan is not None else "")
            if cim else "fp") + (", captured" if captured else "")
    print(f"[serve] {arch} ({mode}, {dev}): batch {batch}, prompt "
          f"{prompt_len}, gen {gen} | pack {t_pack:.3f}s, prefill "
          f"{t_prefill:.3f}s, decode {t_decode:.3f}s "
          f"({decode_tok_s:.1f} tok/s)")
    if return_stats:
        return gen_tokens, stats
    return gen_tokens


def decode_body(params, cfg, tok: torch.Tensor, cache, out: torch.Tensor,
                col: torch.Tensor, temperature: float = 0.0,
                key: Optional[torch.Tensor] = None):
    """``serve``'s decode step as a body of no arguments over static
    state: one ``lm.decode_step`` from ``tok`` (B, 1), the next token
    (greedy, or at ``temperature`` > 0 drawn with one split of ``key``,
    advanced in place) written back into ``tok`` and into column ``col``
    ((1, 1) int64) of ``out`` (B, gen), and ``col`` advanced, all on the
    device.  Returns the step's logits."""
    B = tok.shape[0]

    def body():
        lg, _ = lm.decode_step(params, cfg, tok, cache)
        tok.copy_(lockstep_sample(lg[:, -1], key, temperature))
        out.scatter_(1, col.expand(B, 1), tok)
        col.add_(1)
        return lg
    return body


def round_body(params, cfg, draft_cfg, k: int, tok: torch.Tensor, cache,
               counts: torch.Tensor, target: int, temperature: float = 0.0,
               key: Optional[torch.Tensor] = None):
    """``serve_speculative``'s round as a body of no arguments over static
    state: one ``speculative_round`` from ``tok`` (B, 1) for the rows whose
    ``counts`` ((B,) int64, tokens emitted so far) are below ``target``,
    then ``counts`` and ``tok`` (and at temperature ``key``) advanced, all
    on the device.  Returns the round's emitted tokens and each row's
    count, (B, k+2)."""
    def body():
        emitted, n_emit, new_last, _ = speculative_round(
            params, cfg, draft_cfg, k, tok, cache, counts < target,
            temperature, key)
        counts.add_(n_emit)
        tok.copy_(new_last)
        return torch.cat([emitted, n_emit[:, None]], dim=1)
    return body


def speculative_round(params, cfg, draft_cfg, k: int, last: torch.Tensor,
                      cache, live: torch.Tensor, temperature: float = 0.0,
                      key: Optional[torch.Tensor] = None):
    """One draft/verify round over a lock-step batch.

    ``k`` decode steps under ``draft_cfg`` (same pack), the positions
    rolled back, one ``lm.verify_step`` over the k+1 positions under
    ``cfg``, then the longest agreeing prefix plus the verify model's
    token at the first disagreement (or after the last draft).  At
    ``temperature`` > 0 the drafts are sampled and the block is accepted
    by rejection sampling (``scheduler.rejection_accept``); every draw
    takes one split of ``key``, advanced in place, in the reference's
    order (a draw per draft, the uniforms, the correction).  Rows
    not ``live`` emit nothing and keep their position.  Returns
    (emitted (B, k+1), n_emit (B,), new_last (B, 1), cache); every
    output stays on the device, and ``cache["pos"]`` is written in place
    (the round is one captured body in ``serve_speculative``)."""
    pos = cache["pos"]
    pos0 = pos.clone()
    tok, drafts, d_logits = last, [], []
    for _ in range(k):
        logits, _ = lm.decode_step(params, draft_cfg, tok, cache, live=live)
        if temperature > 0:
            tok = sample_rows(logits[:, -1], _next_subkey(key),
                              temperature)[:, None]
            d_logits.append(logits[:, -1])
        else:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        drafts.append(tok)
    drafts = torch.cat(drafts, dim=1)                       # (B, k)
    pos.copy_(pos0)                                         # rollback
    vlogits, _ = lm.verify_step(params, cfg,
                                torch.cat([last, drafts], dim=1), cache)
    if temperature > 0:
        u = prng.uniform(_next_subkey(key), drafts.shape)
        n_acc, res = rejection_accept(drafts, torch.stack(d_logits, 1),
                                      vlogits, u, temperature)
        emitted = place_correction(
            drafts, n_acc, prng.categorical(_next_subkey(key), res))
    else:
        emitted, n_acc = greedy_accept(drafts, vlogits)
    n_emit = torch.where(live, n_acc + 1, 0)
    new_last = torch.where(live[:, None],
                           torch.gather(emitted, 1, n_acc[:, None]), last)
    pos.copy_(pos0 + n_emit.to(pos0.dtype))
    return emitted, n_emit, new_last, cache


def serve_speculative(arch: str, smoke: bool = True, batch: int = 2,
                      prompt_len: int = 16, gen: int = 48, draft_k: int = 8,
                      draft_adc_bits=None, temperature: float = 0.0,
                      seed: int = 0, plan=None, cim: bool = True,
                      fuse: bool = True,
                      compare_baseline: bool = True,
                      return_stats: bool = False, device=None, params=None,
                      use_kernel=None, graphs: Optional[bool] = None,
                      metrics: bool = False):
    """Plan-cascade speculative lock-step driver.

    The draft plan (``plan.draft_plan_for_model``: the all-analog shadow
    of the serving plan at ``draft_adc_bits``) serves from the same
    packed weights as the deployed plan.
    Each round (``speculative_round``) drafts ``draft_k`` tokens, verifies
    all k+1 positions in one forward and keeps the longest agreeing
    prefix plus a correction.  Text-only, as the reference's: a vlm gets
    no frontend embeddings here, so its tokens are not ``serve``'s (which
    has them) and ``compare_baseline`` is for the text families.  The host reads each round's emitted tokens
    and counts once.  With ``graphs`` (default: on a CUDA device) the
    round is one captured body, the counterpart of the reference's
    compiled round: the first round runs eagerly and is captured, later
    rounds replay it (``launch/graphs.py``).  Greedy tokens equal
    ``serve``'s, which ``compare_baseline`` runs on the same params (and
    the same ``graphs``) and asserts.  At ``temperature`` > 0 the first
    token and every draw of a round come from ``sampling_key(seed)``
    (rejection sampling, ``speculative_round``): the tokens follow the
    verify model's distribution but not ``serve``'s stream, so the
    baseline is timed and not compared.

    Returns tokens (batch, gen) int64; with ``return_stats=True``,
    (tokens, stats) with ``n_rounds``, ``n_drafted``, ``n_accepted``,
    ``acceptance_rate``, ``tokens_per_round`` and ``decode_tok_s`` (and
    ``decode_speedup_speculative`` when ``compare_baseline``); when
    captured, ``capture_s``, ``graph_pool_bytes`` and ``replay_tok_s``
    (the rounds after the first alone).  ``metrics=True`` publishes the
    tokens, drafted and accepted counts and the decode tok/s into
    ``obs.REGISTRY`` and returns ``stats["metrics"]`` and
    ``stats["spans"]``, as ``serve`` does."""
    dev = resolve_device(device)
    captured = use_graphs(graphs, dev)
    if metrics:
        get_tracer().drain()        # stats["spans"]: this call's spans
    cfg, cim = _model_config(arch, smoke, cim, plan, fuse, use_kernel)
    lm.check_speculative(cfg)
    draft_plan = draft_plan_for_model(cfg, draft_adc_bits)
    dcfg = dataclasses.replace(cfg, cim_plan=draft_plan) if cim else cfg
    K = draft_k
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=prompt_len,
                    global_batch=batch, seed=seed, d_model=cfg.d_model)
    float_params = params
    with torch.inference_mode():
        params = (lm.init(seed, cfg, device=dev) if params is None
                  else lm._to_device(params, dev))
        if float_params is None:
            float_params = params
        tokens = torch.from_numpy(batch_at(dc, 0)["tokens"]).to(
            dev, torch.int64)
        _sync(dev)
        t0 = time.perf_counter()
        if cim:
            with span("serve.pack", arch=arch):
                params = lm.pack_cim_params(params, cfg, dev)
                _sync(dev)
        t_pack = time.perf_counter() - t0
        with span("serve.compile", arch=arch):
            _build_kernels(dev, cim)
        # live rows can overshoot the target by up to one block a round,
        # and verify writes k rows past the frontier
        cache = lm.init_cache(cfg, batch, prompt_len + gen + 2 * K + 1,
                              device=dev)
        key = sampling_key(seed, dev) if temperature > 0 else None
        t0 = time.perf_counter()
        with span("serve.prefill", arch=arch):
            logits, cache = lm.prefill(params, cfg, tokens, cache)
            tok = lockstep_sample(logits[:, -1], key, temperature)
            first = tok[:, 0].cpu().numpy()
        t_prefill = time.perf_counter() - t0

        target = gen - 1                  # decode tokens after the first
        rows = [[int(t)] for t in first]
        counts = np.zeros(batch, np.int64)
        counts_dev = torch.zeros((batch,), dtype=torch.int64, device=dev)
        body = round_body(params, cfg, dcfg, K, tok, cache, counts_dev,
                          target, temperature, key)
        round_ = StepGraph(body, dev) if captured else body
        n_rounds = n_drafted = n_accepted = 0
        t0 = time.perf_counter()
        with span("serve.decode", arch=arch, draft_k=K):
            while counts.min() < target:
                got = (_first_call(round_, captured) if n_rounds == 0
                       else round_()).cpu().numpy()
                em, ne = got[:, :K + 1], got[:, K + 1]
                for b in range(batch):
                    rows[b].extend(em[b, :ne[b]].tolist())
                n_drafted += K * int((counts < target).sum())
                n_accepted += int(np.maximum(ne - 1, 0).sum())
                counts += ne
                n_rounds += 1
                if n_rounds == 1:         # the replays start after round 1
                    t_replay0 = time.perf_counter()
                    done1 = int(np.minimum(counts, target).sum())
        t_decode = time.perf_counter() - t0
    gen_tokens = np.asarray([r[:gen] for r in rows], dtype=np.int64)

    decode_tok_s = (batch * target / t_decode if t_decode > 0
                    else float("nan"))
    stats = dict(
        arch=arch, smoke=smoke, n_layers=cfg.n_layers, batch=batch,
        prompt_len=prompt_len, gen=gen, cim=cim, draft_k=K,
        temperature=temperature, device=str(dev),
        draft_plan=draft_plan.summary()["<default>"],
        pack_s=t_pack, prefill_s=t_prefill, decode_s=t_decode,
        decode_tok_s=decode_tok_s, n_rounds=n_rounds,
        n_drafted=n_drafted, n_accepted=n_accepted,
        acceptance_rate=(n_accepted / n_drafted if n_drafted
                         else float("nan")),
        tokens_per_round=(batch * target / n_rounds if n_rounds
                          else float("nan")), graphs=captured)
    if captured and n_rounds > 1:
        stats.update(capture_s=round_.capture_s,
                     graph_pool_bytes=round_.pool_bytes,
                     replay_tok_s=(batch * target - done1)
                     / (t0 + t_decode - t_replay0))
    if metrics:
        REGISTRY.counter("serve_tokens_total",
                         "tokens emitted by the serving drivers").inc(
            batch * gen)
        REGISTRY.counter("serve_drafted_total",
                         "speculative draft tokens proposed").inc(n_drafted)
        REGISTRY.counter("serve_accepted_total",
                         "speculative draft tokens accepted").inc(n_accepted)
        REGISTRY.gauge("serve_decode_tok_s",
                       "lock-step decode throughput").set(decode_tok_s)
        stats["metrics"] = REGISTRY.snapshot()
        stats["spans"] = get_tracer().drain()
    print(f"[serve-spec] {arch} (k={K}, draft {stats['draft_plan']}, "
          f"{dev}): batch {batch}, gen {gen} | decode {t_decode:.3f}s "
          f"({decode_tok_s:.1f} tok/s), acceptance "
          f"{stats['acceptance_rate']:.0%}")
    if compare_baseline:
        base_toks, base = serve(arch, smoke=smoke, batch=batch,
                                prompt_len=prompt_len, gen=gen, cim=cim,
                                temperature=temperature, seed=seed,
                                return_stats=True, fuse=fuse,
                                device=dev, params=float_params,
                                use_kernel=use_kernel, plan=plan,
                                graphs=graphs)
        if temperature <= 0:
            np.testing.assert_array_equal(
                gen_tokens, base_toks,
                err_msg="speculative greedy decode changed tokens vs the "
                        "non-speculative baseline")
            stats["tokens_match_baseline"] = True
        stats["baseline_decode_tok_s"] = base["decode_tok_s"]
        stats["decode_speedup_speculative"] = (
            decode_tok_s / base["decode_tok_s"])
        print(f"[serve-spec] speedup vs non-speculative: "
              f"{stats['decode_speedup_speculative']:.2f}x"
              + (" (tokens identical)" if temperature <= 0 else ""))
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
                     prefix_sharing: bool = True,
                     metrics: Union[bool, ObsConfig] = False,
                     device=None, params=None, plan=None,
                     draft_adc_bits=None, adaptive_draft_k: bool = False,
                     graphs: Optional[bool] = None,
                     noise_seed: Optional[int] = None, repeats: int = 1):
    """Continuous-batching driver: a mixed-length request queue served
    from a fixed pool of ``slots`` decode slots (launch/scheduler.py).
    ``repeats`` reruns the pool (and the lock-step baseline), asserts
    every rerun's tokens equal, keeps the best run for the report and the
    per-run median (``tok_s_median``) for the speedup.

    Returns (tokens_by_rid, stats).  With ``compare_lockstep=True`` the
    same requests also run through the lock-step wave baseline on the
    same pool (contiguous mode) and the per-request tokens are asserted
    equal -- the scheduler may only reorder work, never change it; a
    paged run is compared with the contiguous scheduler instead.
    ``params`` injects float params instead of a fresh init from
    ``seed``; ``plan`` serves a ``DeploymentPlan`` (implies cim).
    ``draft_k > 0`` turns on speculative rounds in the scheduler, drafting
    under the all-analog shadow of the serving plan at
    ``draft_adc_bits``; greedy tokens still equal the non-speculative
    lock-step baseline's.  ``graphs`` (default: on a CUDA device) replays
    the scheduler's pooled step and speculative rounds from captured
    graphs, in every scheduler this driver builds.  ``temperature`` > 0
    samples each request from its own stream under ``sampling_key(seed)``:
    pool tokens still equal the lock-step baseline's, but a speculative
    pool is compared with nothing (rejection sampling matches the
    baseline in distribution only), as in the reference.  ``noise_seed``
    adds the macro's analog noise; it is drawn per pool row, so a noisy
    pool is not compared either.

    ``metrics`` (True or an ``obs.ObsConfig``) serves with the
    scheduler's device rings (``obs/rings.py``): the harvested snapshot
    lands in ``stats["telemetry"]`` and in ``obs.REGISTRY``
    (``stats["metrics"]``), and the pack, compile and workload spans in
    ``stats["spans"]``.  The tokens are the same with metrics on and
    off."""
    obs = (metrics if isinstance(metrics, ObsConfig)
           else (ObsConfig() if metrics else None))
    if obs is not None:
        get_tracer().drain()        # stats["spans"]: this call's spans
    if (draft_k and temperature > 0) or noise_seed is not None:
        compare_lockstep = False
    dev = resolve_device(device)
    use_graphs(graphs, dev)                 # raises before any work
    cfg, cim = _model_config(arch, smoke, cim, plan, fuse,
                             noise_seed=noise_seed)
    draft_plan = (draft_plan_for_model(cfg, draft_adc_bits) if draft_k
                  else None)
    requests = mixed_length_requests(n_requests, prompt_len, cfg.vocab_size,
                                     stop_lengths=stop_lengths, seed=seed)
    cap = max(stop_lengths)
    with torch.inference_mode():
        made = params is None       # params this call owns: packed in place
        params = (lm.init(seed, cfg, device=dev) if made
                  else lm._to_device(params, dev))
        _sync(dev)
        t0 = time.perf_counter()
        if cim:
            with span("serve.pack", arch=arch):
                params = lm.pack_cim_params(params, cfg, dev, consume=made)
                _sync(dev)
        t_pack = time.perf_counter() - t0
        with span("serve.compile", arch=arch, n_queue=n_requests):
            _build_kernels(dev, cim)
    spec = dict(draft_k=draft_k, draft_plan=draft_plan,
                adaptive_draft_k=adaptive_draft_k, graphs=graphs,
                temperature=temperature, seed=seed)
    sched = ContinuousBatchingScheduler(
        params, cfg, slots=slots, prompt_len=prompt_len, max_new_cap=cap,
        paged=paged, prefill_chunk=prefill_chunk,
        prefix_sharing=prefix_sharing, obs=obs, **spec)
    with span("serve.workload", arch=arch, n_requests=n_requests,
              repeats=repeats):
        runs = [sched.run(requests) for _ in range(repeats)]
    want = runs[0].tokens_by_rid()
    for other in runs[1:]:
        for rid, toks in other.tokens_by_rid().items():
            np.testing.assert_array_equal(toks, want[rid])
    report = max(runs, key=lambda r: r.tok_s)
    stats = dict(arch=arch, n_layers=cfg.n_layers, slots=slots,
                 prompt_len=prompt_len, n_requests=n_requests, cim=cim,
                 temperature=temperature, noise_seed=noise_seed,
                 device=str(dev), pack_s=round(t_pack, 4),
                 graphs=sched.graphs, capture=sched.graph_stats(),
                 continuous=report.summary(), repeats=repeats,
                 tok_s_median=statistics.median(r.tok_s for r in runs),
                 n_iter=report.n_iter,
                 host_syncs=report.host_syncs,
                 host_syncs_per_iter=report.host_syncs / max(report.n_iter, 1),
                 iter_ms=1e3 * report.wall_s / max(report.n_iter, 1),
                 branch_counts=report.branch_counts,
                 branch_ms_per_iter={
                     b: 1e3 * t / report.branch_counts[b]
                     for b, t in report.branch_s.items()
                     if report.branch_counts[b]})
    if plan is not None:
        stats["plan"] = plan.summary()
    if draft_k:
        stats.update(draft_k=draft_k,
                     draft_plan=draft_plan.summary()["<default>"],
                     adaptive_draft_k=adaptive_draft_k,
                     draft_steps=report.draft_steps)
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
                max_new_cap=cap, **spec).run(requests).tokens_by_rid()
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
        base_runs = [sched.run_lockstep(requests) for _ in range(repeats)]
        for base in base_runs:
            for rid, toks in base.tokens_by_rid().items():
                np.testing.assert_array_equal(
                    want[rid], toks,
                    err_msg=f"request {rid}: continuous batching changed "
                            "tokens vs the lock-step baseline")
        base = max(base_runs, key=lambda r: r.tok_s)
        base_median = statistics.median(r.tok_s for r in base_runs)
        stats["lockstep"] = base.summary()
        stats["lockstep_tok_s_median"] = base_median
        stats["tokens_match_lockstep"] = True
        stats["speedup_vs_lockstep"] = round(
            stats["tok_s_median"] / base_median, 2)
    if obs is not None:
        report.obs.register(REGISTRY)
        REGISTRY.gauge("serve_decode_tok_s",
                       "continuous-batching throughput").set(report.tok_s)
        stats["telemetry"] = report.obs.to_dict()
        stats["metrics"] = REGISTRY.snapshot()
        stats["spans"] = get_tracer().drain()
    mode = "cim-packed" if cim else "fp"
    if draft_k:
        mode += f"+spec-k{draft_k}" + ("-adaptive" if adaptive_draft_k
                                       else "")
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


def serve_guarded(arch: str, smoke: bool = True, slots: int = 2,
                  prompt_len: int = 16, n_requests: int = 8,
                  stop_lengths=(4, 16, 8, 12), temperature: float = 0.0,
                  seed: int = 0, plan=None, fuse: bool = True,
                  draft_k: int = 0, paged: Optional[PagedLayout] = None,
                  prefill_chunk: Optional[int] = None,
                  prefix_sharing: bool = True, fault=None, watchdog=True,
                  probe: bool = True, segment_iters: int = 8,
                  start_rung: Optional[int] = None, device=None,
                  params=None, graphs: Optional[bool] = None):
    """Watchdog-guarded continuous serving with plan-degradation failover
    (the reference's ``serve_guarded``, argument for argument, plus
    ``device``, ``params`` (float params instead of a fresh init from
    ``seed``) and ``graphs``).

    The queue runs through ``resilience.failover.GuardedServer``: one
    pack-compatible scheduler per ladder rung over one packed weight set
    and one pool state, in budget-bounded segments with the health read
    at each boundary (ADC clip rate, speculative acceptance, golden
    probe).  ``fault`` (a ``resilience.faults.FaultModel`` or its
    ``FaultModel.parse`` spec) arms deterministic analog drift on the
    loop's device clock.  Every rung's graphs are captured before the
    first request (on a CUDA device).  Returns (tokens_by_rid, stats);
    ``stats["resilience"]`` is the ``ResilienceLog.to_dict()``."""
    from ..resilience.failover import GuardedServer, default_probe
    from ..resilience.faults import FaultModel
    from ..resilience.watchdog import Watchdog, WatchdogConfig

    if isinstance(fault, str):
        fault = FaultModel.parse(fault)
    if watchdog is True:
        watchdog = Watchdog()
    elif isinstance(watchdog, WatchdogConfig):
        watchdog = Watchdog(watchdog)
    elif watchdog is False:
        watchdog = None
    dev = resolve_device(device)
    use_graphs(graphs, dev)                 # raises before any work
    # resilience is a macro feature: the ladder degrades between analog,
    # hybrid and digital executions of one packed weight set
    cfg, _ = _model_config(arch, smoke, True, plan, fuse)
    with torch.inference_mode():
        made = params is None       # params this call owns: packed in place
        params = (lm.init(seed, cfg, device=dev) if made
                  else lm._to_device(params, dev))
        _sync(dev)
        t0 = time.perf_counter()
        with span("serve.pack", arch=arch):
            params = lm.pack_cim_params(params, cfg, dev, consume=made)
            _sync(dev)
        t_pack = time.perf_counter() - t0
    gp = default_probe(params, fault=fault) if probe else None
    server = GuardedServer(
        params, cfg, slots=slots, prompt_len=prompt_len,
        max_new_cap=max(stop_lengths), temperature=temperature, seed=seed,
        draft_k=draft_k, paged=paged, prefill_chunk=prefill_chunk,
        prefix_sharing=prefix_sharing, watchdog=watchdog, probe=gp,
        fault=fault, segment_iters=segment_iters, start_rung=start_rung,
        graphs=graphs)
    requests = mixed_length_requests(n_requests, prompt_len, cfg.vocab_size,
                                     stop_lengths=stop_lengths, seed=seed)
    t0 = time.perf_counter()
    with span("serve.compile", arch=arch, n_queue=n_requests):
        _build_kernels(dev, True)
        server.compile_for(n_requests)
        _sync(dev)
    t_compile = time.perf_counter() - t0
    with span("serve.workload", arch=arch, n_requests=n_requests):
        report, log = server.run(requests)

    stats = dict(arch=arch, slots=slots, prompt_len=prompt_len,
                 n_requests=n_requests, stop_lengths=list(stop_lengths),
                 draft_k=draft_k, segment_iters=segment_iters,
                 device=str(dev),
                 fault=None if fault is None else dataclasses.asdict(fault),
                 pack_s=round(t_pack, 4), compile_s=round(t_compile, 4),
                 n_compiles=server.n_compiles, captures=server.captures(),
                 continuous=report.summary(),
                 resilience=log.to_dict())
    state = watchdog.state if watchdog is not None else "(no watchdog)"
    line = (f"[serve-guarded] {arch} ({dev}): {n_requests} reqs over "
            f"{slots} slots | {report.tok_s:.1f} tok/s | health {state}, "
            f"serving rung '{log.rung_labels[log.final_rung]}'")
    if log.actions:
        line += f", {len(log.actions)} failover action(s)"
    if fault is not None and log.detection_tokens is not None:
        line += f" | fault detected at {log.detection_tokens} tokens"
    print(line)
    return report.tokens_by_rid(), stats


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
    ap.add_argument("--no-pack", dest="pack", action="store_false",
                    help="(--cim, lock-step) serve the raw weights, "
                         "quantized at every call, not a pack")
    ap.add_argument("--no-fuse", dest="fuse", action="store_false")
    ap.add_argument("--speculative", action="store_true",
                    help="plan-cascade speculative decoding (analog draft "
                         "and deployed verify from one pack; implies "
                         "--cim)")
    ap.add_argument("--draft-k", type=int, default=8,
                    help="(--speculative) draft block length per round")
    ap.add_argument("--draft-adc-bits", type=int, default=None,
                    help="(--speculative) draft SAR width (default: the "
                         "smallest non-clipping width per entry)")
    ap.add_argument("--adaptive-draft-k", action="store_true",
                    help="(--speculative --continuous) feed the measured "
                         "acceptance back into the draft depth")
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
    ap.add_argument("--watchdog", action="store_true",
                    help="guarded continuous serving: drift watchdog and "
                         "plan-degradation failover ladder over one pack")
    ap.add_argument("--inject-fault", type=str, default=None, metavar="SPEC",
                    help="arm a deterministic analog FaultModel on the "
                         "loop's device clock, e.g. 'gain_amp=0.5,"
                         "schedule=ramp,onset=8,period=32' (see "
                         "resilience.faults.FaultModel; implies --watchdog)")
    ap.add_argument("--segment-iters", type=int, default=8,
                    help="(--watchdog) scheduler iterations per guarded "
                         "segment between health checks")
    ap.add_argument("--no-graphs", dest="graphs", action="store_false",
                    default=None,
                    help="run every decode step, speculative round and "
                         "pooled step eagerly (default: replay captured "
                         "CUDA graphs on a CUDA device)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sample at this temperature (default: greedy)")
    ap.add_argument("--noise-seed", type=int, default=None,
                    help="(--cim) emulate the macro's analog noise from "
                         "this seed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain reference path)")
    ap.add_argument("--metrics", action="store_true",
                    help="telemetry: the scheduler's device rings "
                         "(--continuous) and the metrics registry")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write the Prometheus text exposition here "
                         "(implies --metrics)")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="append JSON-lines span traces here")
    args = ap.parse_args()
    metrics = args.metrics or bool(args.metrics_out)
    if args.trace_out:
        set_trace_path(args.trace_out)
    if not args.pack and (args.continuous or args.speculative):
        ap.error("--no-pack serves lock-step only")
    draft_k = args.draft_k if args.speculative else 0
    paged = None
    if args.paged_blocks:
        # the default workload's longest budget is 16 tokens, and a
        # speculative round writes draft_k rows past it
        paged = PagedLayout(
            block_size=args.block_size,
            n_tbl=cdiv(args.prompt_len + 16 + draft_k, args.block_size),
            n_blocks=args.paged_blocks)
    if args.watchdog or args.inject_fault:
        serve_guarded(args.arch, smoke=args.smoke, slots=args.batch,
                      prompt_len=args.prompt_len, n_requests=args.requests,
                      temperature=args.temperature, seed=args.seed,
                      fuse=args.fuse, draft_k=draft_k, paged=paged,
                      prefill_chunk=args.prefill_chunk,
                      prefix_sharing=args.prefix_sharing,
                      fault=args.inject_fault,
                      segment_iters=args.segment_iters, device=args.device,
                      graphs=args.graphs)
    elif args.continuous:
        toks, _ = serve_continuous(
            args.arch, smoke=args.smoke, slots=args.batch,
            prompt_len=args.prompt_len, n_requests=args.requests,
            cim=args.cim or args.speculative, seed=args.seed, fuse=args.fuse,
            paged=paged, prefill_chunk=args.prefill_chunk,
            prefix_sharing=args.prefix_sharing, device=args.device,
            draft_k=draft_k, draft_adc_bits=args.draft_adc_bits,
            adaptive_draft_k=args.adaptive_draft_k, graphs=args.graphs,
            temperature=args.temperature, noise_seed=args.noise_seed,
            metrics=metrics)
        for rid in sorted(toks):
            print(rid, toks[rid].tolist())
    elif args.speculative:
        toks = serve_speculative(
            args.arch, smoke=args.smoke, batch=args.batch,
            prompt_len=args.prompt_len, gen=args.gen, draft_k=args.draft_k,
            draft_adc_bits=args.draft_adc_bits, seed=args.seed,
            fuse=args.fuse, device=args.device, graphs=args.graphs,
            temperature=args.temperature, metrics=metrics)
        print(np.array2string(toks, max_line_width=120))
    else:
        toks = serve(args.arch, smoke=args.smoke, batch=args.batch,
                     prompt_len=args.prompt_len, gen=args.gen, cim=args.cim,
                     seed=args.seed, fuse=args.fuse, device=args.device,
                     graphs=args.graphs, temperature=args.temperature,
                     noise_seed=args.noise_seed, pack=args.pack,
                     metrics=metrics)
        print(np.array2string(toks, max_line_width=120))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(REGISTRY.export_prometheus())
        print(f"[serve] metrics exposition -> {args.metrics_out}")


if __name__ == "__main__":
    main()
