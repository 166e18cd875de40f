#!/usr/bin/env python3
"""Where serving telemetry costs time on the card, and the paged pool's
iterations against the contiguous one's.

  python3 tools/telemetry_cost.py

Two parts, each printing JSON lines:

  pools  the serve_bench twin's multi-tenant pools at the smoke config
         (``serve_bench._trace_pools``: 10 requests, 3 slots, context
         128, blocks of 8, chunks of 16, fp, its arrivals): contiguous,
         paged, paged with metrics; tok/s of three runs after a warm
         one, and ms per iteration by branch (the best of the three).
  full   ``chip_smoke.py`` phase 36 (b)'s paged queue at full width
         (minicpm-2b, prototype macro, packed): metrics off, on, and on
         with no tap collector (its kernels count no clip), in turns;
         tok/s and ms per iteration by branch; then kernel row 1 alone
         at phase 36 (d)'s three shapes, M 8, 16 and 32, device time per
         call with the clip counter on and off (CUDA-graph replays).

Needs a CUDA device; prints the card's name and power limit first.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def _runs(scheds, turns: int = 4) -> dict:
    """Each scheduler ``(sched, requests, arrivals)`` run ``turns`` times
    in turns; the first turn is a warm-up (graph capture)."""
    out = {}
    for turn in range(turns):
        for name, (sched, reqs, arrivals) in scheds.items():
            rep = sched.run(reqs, arrivals)
            if turn == 0:
                continue
            r = out.setdefault(name, dict(tok_s=[], ms_per_iter={},
                                          branch_counts=rep.branch_counts))
            r["tok_s"].append(rep.tok_s)
            for b, t in rep.branch_s.items():
                if rep.branch_counts[b]:
                    r["ms_per_iter"].setdefault(b, []).append(
                        1e3 * t / rep.branch_counts[b])
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("telemetry_cost: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.core.ccim import DEFAULT_CONFIG as D
    from repro_torch.core.ccim import quantize_smf, smf_scale
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.launch import serve_bench as SB
    from repro_torch.launch.paging import PagedLayout, cdiv
    from repro_torch.launch.scheduler import (ContinuousBatchingScheduler,
                                              Request, multi_tenant_trace)
    from repro_torch.models import lm
    from repro_torch.obs import ObsConfig

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")

    class NoCount(ContinuousBatchingScheduler):
        """Metrics on, no tap collector: the kernels count no clip."""
        def _collector(self):
            return contextlib.nullcontext()

    # -- pools: the twin's multi-tenant pools at the smoke config -----------
    cfg, params, reqs, arrivals, lay, kw = SB._trace_pools(
        "minicpm-2b", True, 3, 128, 64, 10, 8, 0, dev)
    padded = [Request(rid=r.rid, max_new_tokens=r.max_new_tokens,
                      prompt=np.concatenate(
                          [r.prompt, np.zeros(128 - len(r.prompt), np.int32)]))
              for r in reqs]
    paged = dict(kw, paged=lay, prefill_chunk=16)
    pools = _runs({
        "contiguous": (ContinuousBatchingScheduler(params, cfg, **kw),
                       padded, arrivals),
        "paged": (ContinuousBatchingScheduler(params, cfg, **paged), reqs,
                  arrivals),
        "paged_metrics": (ContinuousBatchingScheduler(
            params, cfg, obs=ObsConfig(), **paged), reqs, arrivals)})
    for name, r in pools.items():
        r["ms_per_iter"] = {b: min(v) for b, v in r["ms_per_iter"].items()}
        print(json.dumps({"part": "pools", "pool": name, **r}), flush=True)
    del params

    # -- full: phase 36 (b)'s queue at full width ----------------------------
    cfg = dataclasses.replace(get_config("minicpm-2b"), cim_mode=True)
    with torch.inference_mode():
        packed = lm.pack_cim_params(lm.init(0, cfg, device=dev), cfg, dev)
    reqs, arrivals = multi_tenant_trace(CS.MT_REQUESTS, CS.MT_MAX_PROMPT,
                                        cfg.vocab_size, CS.MT_BS,
                                        arrival_rate=CS.MT_RATE)
    lay = PagedLayout(block_size=CS.MT_BS,
                      n_tbl=cdiv(CS.MT_PROMPT + CS.MT_CAP, CS.MT_BS),
                      n_blocks=2 * CS.MT_SLOTS * cdiv(
                          CS.MT_MAX_PROMPT + CS.MT_CAP, CS.MT_BS) + 8)
    kw = dict(slots=CS.MT_SLOTS, prompt_len=CS.MT_PROMPT,
              max_new_cap=CS.MT_CAP, paged=lay, prefill_chunk=CS.MT_CHUNK)
    full = _runs({
        "off": (ContinuousBatchingScheduler(packed, cfg, **kw), reqs,
                arrivals),
        "on": (ContinuousBatchingScheduler(packed, cfg, obs=ObsConfig(),
                                           **kw), reqs, arrivals),
        "on_no_count": (NoCount(packed, cfg, obs=ObsConfig(), **kw), reqs,
                        arrivals)}, turns=5)
    for name, r in full.items():
        r["ms_per_iter"] = {b: min(v) for b, v in r["ms_per_iter"].items()}
        print(json.dumps({"part": "full", "scheduler": name, **r}),
              flush=True)
    del packed

    # -- row 1 alone, counter on and off -------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    meta = dict(acc_len=16, x_bits=(6, 5), dcim_lsb=D.dcim_lsb,
                adc_half=D.adc_half_range)
    buf = torch.zeros((1,), dtype=torch.int32, device=dev)
    rows = {}
    for k, n in CS.CLIP_SHAPES:
        v = torch.randn((n, k), generator=gen, device=dev)
        wq = quantize_smf(v, smf_scale(v, dim=-1, keepdim=True)).t()
        p = engine.pack_quantized_cim_weights(
            wq, torch.ones((1, n), device=dev), D)
        for m in (8, 16, 32):
            x = torch.randint(-60, 60, (m, k), generator=gen,
                              device=dev).to(torch.int8)
            call = lambda clips=None: K.ccim_matmul_prepacked_skinny_cuda(
                x, p.kernel_w, p.kernel_planes, **meta, clips=clips)
            t = rows.setdefault(m, {"on": 0.0, "off": 0.0})
            t["on"] += CS.graph_ms(torch, lambda: call(buf))
            t["off"] += CS.graph_ms(torch, call)
    print(json.dumps({"part": "row1_counter", "shapes": CS.CLIP_SHAPES,
                      "device_ms_by_m": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
