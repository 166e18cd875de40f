#!/usr/bin/env python3
"""Where a speculative verify forward and the chain of decode steps part.

  python3 tools/verify_divergence.py [--start 15] [--k 8] [--layers 40]

Full-width minicpm-2b (random weights from seed 0, packed, prototype
macro), batch 2, prompt 16: the prompt is prefilled and ``--start``
greedy tokens are committed by decode steps; then the next k + 1 tokens
go through k + 1 decode steps and, from the same cache, through one
``lm.verify_step``.  Every call of the forward's row-local operations
(rms_norm, the projections, the attention read, the lm_head GEMM) is
recorded in both, and the first call whose output differs between the
two is printed with the position, the largest difference and the inputs'
difference, as JSON lines.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))


def main() -> int:
    import dataclasses

    import torch
    if not torch.cuda.is_available():
        print("verify_divergence: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    ap = argparse.ArgumentParser()
    ap.add_argument("--start", type=int, default=15)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--layers", type=int, default=40)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("minicpm-2b"), cim_mode=True,
                              n_layers=args.layers)
    B, P, S = 2, 16, args.k + 1
    params = lm.init(0, dataclasses.replace(cfg, n_layers=40), device=dev)
    params["layers"] = {k: {n: t[:args.layers] for n, t in v.items()}
                        if isinstance(v, dict) else v[:args.layers]
                        for k, v in params["layers"].items()}
    calls = []
    rec = {"on": False}

    def wrap(name, fn, out_of=lambda r: r):
        def inner(*a, **kw):
            r = fn(*a, **kw)
            if rec["on"]:
                ins = [t for t in a if isinstance(t, torch.Tensor)]
                calls.append((name, out_of(r).detach().clone(),
                              ins[0].detach().clone() if ins else None))
            return r
        return inner

    L.rms_norm = wrap("rms_norm", L.rms_norm)
    L.matmul = wrap("matmul", L.matmul)
    L.plain_attention = wrap("plain_attention", L.plain_attention)
    L._dense = wrap("dense", L._dense)
    L._dense_fused = wrap("dense_fused", L._dense_fused,
                          lambda r: torch.cat(list(r.values()), -1))

    with torch.inference_mode():
        packed = lm.pack_cim_params(params, cfg, dev)
        prompt = torch.from_numpy(batch_at(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=P, global_batch=B, seed=0),
            0)["tokens"]).to(dev, torch.int64)
        cache = lm.init_cache(cfg, B, P + args.start + 2 * S + 1, device=dev)
        lg, cache = lm.prefill(packed, cfg, prompt, cache)
        tok = torch.argmax(lg[:, -1], -1)[:, None]
        for _ in range(args.start):
            lg, cache = lm.decode_step(packed, cfg, tok, cache)
            tok = torch.argmax(lg[:, -1], -1)[:, None]
        clone = {n: v.clone() for n, v in cache.items()}
        block, chain_calls, chain_logits = [tok], [], []
        rec["on"] = True
        for i in range(S):
            calls.clear()
            lg, cache = lm.decode_step(packed, cfg, block[-1], cache)
            chain_calls.append(list(calls))
            chain_logits.append(lg[:, -1])
            block.append(torch.argmax(lg[:, -1], -1)[:, None])
        calls.clear()
        vlg, _ = lm.verify_step(packed, cfg, torch.cat(block[:S], 1), clone)
        verify_calls = list(calls)
    n = len(verify_calls)
    print(json.dumps({"calls_per_forward": n,
                      "chain_calls": [len(c) for c in chain_calls]}))
    first = None
    for j in range(n):
        name, vout, vin = verify_calls[j]
        for s in range(S):
            cname, cout, cin = chain_calls[s][j]
            vo = vout.reshape(B, S, -1)[:, s] if vout.dim() == 3 else None
            if vo is None:            # attention output (B, S, H, Dh)
                vo = vout[:, s].reshape(B, -1)
            co = cout.reshape(B, -1)
            if not torch.equal(vo.reshape(B, -1), co):
                vi = vin.reshape(B, S, -1)[:, s] if vin is not None else None
                ci = cin.reshape(B, -1) if cin is not None else None
                first = {"call": j, "op": name, "position": s,
                         "layer_estimate": j * 40 // n,
                         "max_abs_out_diff": float(
                             (vo.reshape(B, -1).float() - co.float()
                              ).abs().max()),
                         "rows_differing": int((vo.reshape(B, -1) != co)
                                               .any(1).sum()),
                         "inputs_equal": (None if vi is None else bool(
                             torch.equal(vi.reshape(B, -1), ci)))}
                break
        if first:
            break
    print(json.dumps({"first_difference": first,
                      "max_abs_logit_diff": float(
                          (vlg - torch.stack(chain_logits, 1)).abs().max())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
