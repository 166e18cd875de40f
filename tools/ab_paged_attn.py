"""Kernel row 3 (the paged-attention decode read) of two checkouts of
this repo, timed in one process each, in turns A B B A, on one CUDA card.

    python3 tools/ab_paged_attn.py --a DIR_A --b DIR_B \
        [--shape minicpm-2b|gemma2-9b|paligemma-3b] \
        [--lengths 96 1024 4096] [--batch 8] [--pooled-step]

Each DIR is the root of a checkout: its ``src/repro_torch`` is imported
and its kernels are built into its own ``build/``.  Each turn calls
``paged_attention_cuda`` (the same signature in every checkout that has
it) for each length of ``--lengths``, on the operands of ``chip_smoke.py``
phase 13 made on the card (``chip_smoke.paged_pools``, block size 16):
``--shape minicpm-2b`` (the default) at its decode shape (``--batch``
rows, 48 heads, G 1, Dh 64; seed 13), ``gemma2-9b`` and
``paligemma-3b`` at phase 13's head dim 256 cases
(``chip_smoke.PA_DH256``: batch, heads, softcap and window as there,
``--batch`` ignored; seed 256).  ``--pooled-step`` instead serves
phase 46's gemma2-9b paged queue at full width and depth in each turn
and reports row 3's device time in its traced 10th pooled step, a graph
replay (``chip_smoke.pooled_step_tracer``).
``ms`` is CUDA events around one call (host wrapper included),
``device_ms`` CUDA-graph replays on one KV pool, and ``device_cold_ms``
replays rotating over distinct pools (``chip_smoke.cold_copy_count``: at
least 4 and 4 L2s of bytes), as a decode step's layers read distinct
pools.  The checkouts may sum in different float32 orders, so instead of
comparing hashes each turn holds its output to the plain version within
phase 8's tolerance (rtol 2^-7, atol 2^-7 max|v|) and the script exits 1
if a turn misses it.  The last line holds both checkouts' times side by
side, per length.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pooled_turn(root: str) -> dict:
    """Row 3's device time in a traced replayed pooled step of
    ``root``'s gemma2-9b paged pool (``chip_smoke.py`` phase 46's queue,
    full width and depth)."""
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(1, ROOT)
    import torch
    from chip_smoke import _dense_model, dense_paged_queue, pooled_step_tracer

    dev = torch.device("cuda")
    cfg, packed, _ = _dense_model(torch, dev, "gemma2-9b", 46)
    sched, reqs = dense_paged_queue(cfg, packed)
    on_branch, result = pooled_step_tracer(torch)
    toks = sched.run(reqs, on_branch=on_branch).tokens_by_rid()
    rec = result()
    return {"root": root, "shape": "gemma2-9b pooled step",
            "tokens": {str(r): [int(t) for t in v] for r, v in toks.items()},
            "pooled": {k: rec[k] for k in (
                "row3_device_ms", "row3_kernels", "step_wall_ms",
                "device_busy_ms", "device_events_per_step", "at_step")}}


def turn(root: str, lengths, batch: int, shape: str) -> dict:
    """Times of ``root``'s paged-attention kernel per length."""
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(1, ROOT)
    import torch
    from chip_smoke import (PA_DH, PA_DH256, PA_HEADS, cold_copy_count,
                            cuda_ms, graph_ms, graph_rotation_ms,
                            paged_pool_bytes, paged_pools, paged_tolerance_ok)
    from repro_torch.kernels.paged_attn import kernel as PK
    from repro_torch.kernels.paged_attn import ref as PR

    if shape == "minicpm-2b":
        hq = hkv = PA_HEADS
        dh, softcap, window, local, seed = PA_DH, None, None, False, 13
    else:
        batch, hq, hkv, softcap, window, local = PA_DH256[shape]
        dh, seed = 256, 256
    kw = dict(softcap=softcap, window=window)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    by_length = {}
    for L in lengths:
        copies = cold_copy_count(torch, dev,
                                 paged_pool_bytes(batch, L, hkv, dh))
        q, pools, table, lens = paged_pools(torch, dev, gen, batch, L, copies,
                                            hq, hkv, dh)
        kp, vp = pools[0]
        fn = lambda kp=kp, vp=vp: PK.paged_attention_cuda(
            q, kp, vp, table, lens, local, **kw)
        ok = paged_tolerance_ok(torch, fn(), PR.paged_attention_ref(
            q, kp, vp, table, lens, is_local=local, **kw), vp)
        by_length[L] = dict(
            ms=cuda_ms(fn, reps=50), device_ms=graph_ms(torch, fn),
            device_cold_ms=graph_rotation_ms(torch, [
                lambda kp=kp, vp=vp: fn(kp, vp) for kp, vp in pools]),
            copies=copies, within_tolerance=ok)
        del pools, kp, vp
    return {"root": root, "module": PK.__file__, "shape": shape,
            "batch": batch, "heads": [hq, hkv, dh], "by_length": by_length}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", required=True, help="root of checkout A")
    ap.add_argument("--b", required=True, help="root of checkout B")
    ap.add_argument("--lengths", type=int, nargs="+", default=[96, 1024, 4096],
                    help="context lengths, one or more")
    ap.add_argument("--batch", type=int, default=8,
                    help="rows (minicpm-2b's shape)")
    ap.add_argument("--shape", default="minicpm-2b",
                    choices=("minicpm-2b", "gemma2-9b", "paligemma-3b"))
    ap.add_argument("--pooled-step", action="store_true",
                    help="instead: row 3's device time in a traced "
                         "replayed pooled step of gemma2-9b's paged pool")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        root = os.path.abspath(args.turn)
        print(json.dumps(pooled_turn(root) if args.pooled_step else turn(
            root, args.lengths, args.batch, args.shape)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    runs = []
    for label, root in (("A", args.a), ("B", args.b), ("B", args.b),
                        ("A", args.a)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--a", args.a,
             "--b", args.b, "--lengths", *map(str, args.lengths),
             "--batch", str(args.batch), "--shape", args.shape,
             "--turn", root] + ["--pooled-step"] * args.pooled_step,
            capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["label"] = label
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    if args.pooled_step:
        print(json.dumps({"kernel": "paged", "shape": "gemma2-9b pooled step",
                          "row3_device_ms": {label: [
                              r["pooled"]["row3_device_ms"] for r in runs
                              if r["label"] == label] for label in "AB"}}))
        return 0
    ok = all(t["within_tolerance"] for run in runs
             for t in run["by_length"].values())
    per_length = {L: {label: [{k: r["by_length"][L][k] for k in (
        "ms", "device_ms", "device_cold_ms")} for r in runs
        if r["label"] == label] for label in ("A", "B")}
        for L in runs[0]["by_length"]}
    print(json.dumps({"kernel": "paged", "shape": args.shape,
                      "batch": runs[0]["batch"],
                      "per_length": per_length,
                      "outputs_within_tolerance": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
