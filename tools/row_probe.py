#!/usr/bin/env python3
"""Row invariance of the forward's float operations on the card, and what
the row-invariant forms cost.

  python3 tools/row_probe.py

A speculative verify forward runs k+1 positions of each row where a
decode step runs one, so every operation whose per-row result depends on
the number of rows breaks the greedy contract (verify logits == the
decode chain's).  For the bf16 GEMMs (the lm_head, and every
projection a plan's 'float' site can put on the verify path: wq/wk/wv,
wo, w1/w3 and w2), rms_norm and the plain attention read at minicpm-2b's
full-width shapes this prints, as JSON
lines: how many output rows of the library form (``x @ w``,
``torch.mean`` on float32 rows, a softmax sum and an ``einsum``) differ
between a run over m rows and the same rows taken from a larger run,
and between (B, 9, D) rows and each position alone (the verify layout);
the same counts for the port's forms (``models/layers.py``: fixed 64-row
GEMM tiles and ``_tree_sum``); and the CUDA-event time of one call of
each form (host wrapper included).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

D, V, H, DH = 2304, 122753, 48, 64
# the float-site projections' (K, N) at minicpm-2b's width
FLOAT_SITES = {"wq_wk_wv": (2304, 3072), "wo": (3072, 2304),
               "w1_w3": (2304, 5760), "w2": (5760, 2304)}
ROWS = (1, 2, 4, 8, 9, 16, 18, 32, 36, 40)


def cuda_ms(torch, fn, reps=20):
    for _ in range(3):
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def differing_rows(torch, fn, x, rows):
    """Rows of fn(x[:m]) that differ from fn(x)[:m], summed over ``rows``."""
    full = fn(x)
    return {m: int((fn(x[:m]) != full[:m]).reshape(m, -1).any(1).sum())
            for m in rows}


def differing_positions(torch, fn, x, batch, s=9):
    """The verify layout: rows of fn over (batch, s, D) that differ from
    fn over each position alone, (batch, 1, D), as a decode step runs it."""
    x3 = x[:batch * s].reshape(batch, s, -1)
    full = fn(x3)
    return sum(int((fn(x3[:, i:i + 1].contiguous())[:, 0] != full[:, i])
                   .reshape(batch, -1).any(1).sum()) for i in range(s))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("row_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = max(ROWS)
    # rms_norm's input in the model is the unrounded float32 residual sum
    xf = torch.randn((n, D), generator=gen, device=dev)
    x = xf.to(torch.bfloat16)
    w = (torch.randn((D, V), generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    g = torch.randn((D,), generator=gen, device=dev).to(torch.bfloat16)

    def mean_norm(t):
        r = torch.rsqrt(torch.mean(t * t, dim=-1, keepdim=True) + 1e-6)
        return t * r * (1.0 + g.float())

    ops = {"lm_head": (lambda t: t @ w, lambda t: L.matmul(t, w), x),
           "rms_norm": (mean_norm, lambda t: L.rms_norm(t, g, 1e-6), xf)}
    for name, (k_dim, n_dim) in FLOAT_SITES.items():
        xs = torch.randn((n, k_dim), generator=gen, device=dev).to(
            torch.bfloat16)
        ws = (torch.randn((k_dim, n_dim), generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
        ops[name] = (lambda t, ws=ws: t @ ws,
                     lambda t, ws=ws: L.matmul(t, ws), xs)
    for name, (lib, port, x) in ops.items():
        rec = {"op": name, "rows": list(ROWS),
               "library_rows_differing": differing_rows(torch, lib, x, ROWS),
               "port_rows_differing": differing_rows(torch, port, x, ROWS),
               "verify_layout_rows_differing": {
                   f"library_b{b}": differing_positions(torch, lib, x, b)
                   for b in (2, 4)} | {
                   f"port_b{b}": differing_positions(torch, port, x, b)
                   for b in (2, 4)}}
        for m in (4, 18, 36):
            rec[f"library_ms_m{m}"] = cuda_ms(torch, lambda: lib(x[:m]))
            rec[f"port_ms_m{m}"] = cuda_ms(torch, lambda: port(x[:m]))
        print(json.dumps(rec), flush=True)

    # the plain attention read: B 4 rows of a 57-row cache, 9 queries a row
    # (a verify block) against one query at a time (the decode chain), and
    # against the same cache grown to 81 rows (masked), as lock-step and
    # speculative serving size their caches differently
    cfg = get_config("minicpm-2b")
    B, S, Sk, Sk2 = 4, 9, 57, 81
    bf = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = bf(B, S, H, DH), bf(B, Sk2, H, DH), bf(B, Sk2, H, DH)
    kpos2 = torch.arange(Sk2, device=dev)[None].expand(B, Sk2)
    kpos2 = torch.where(kpos2 < 40, kpos2, 10 ** 9)
    qpos = 31 + torch.arange(S, device=dev)[None].expand(B, S)

    def lib_attn(qq, qp, n):
        qg = L._scale_q(qq.reshape(B, qq.shape[1], H, 1, DH))
        s = L._lane_scores(qg, k[:, :n].to(torch.float32))
        msk = L._mask(qp, kpos2[:, :n], False, None, 0)
        s = torch.where(msk[:, None, None, :, :], s, -1e30)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        return torch.einsum("bhgqk,bkhd->bqhgd",
                            p.to(v.dtype).to(torch.float32),
                            v[:, :n].to(torch.float32)).to(v.dtype)

    def port_attn(qq, qp, n):
        return L.plain_attention(qq, k[:, :n], v[:, :n], qp, kpos2[:, :n],
                                 cfg, False)

    for name, fn in (("plain_attention_library", lib_attn),
                     ("plain_attention_port", port_attn)):
        full = fn(q, qpos, Sk).reshape(B, S, -1)
        diff = sum(int((fn(q[:, i:i + 1], qpos[:, i:i + 1], Sk).reshape(
            B, -1) != full[:, i]).any(1).sum()) for i in range(S))
        longer = fn(q, qpos, Sk2).reshape(B, S, -1)
        print(json.dumps({
            "op": name, "query_rows_differing": diff, "of": B * S,
            "query_rows_differing_cache_81_vs_57": int(
                (longer != full).any(-1).sum()),
            "ms_decode_s1": cuda_ms(torch, lambda: fn(q[:, :1],
                                                      qpos[:, :1], Sk)),
            "ms_verify_s9": cuda_ms(torch, lambda: fn(q, qpos, Sk))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
