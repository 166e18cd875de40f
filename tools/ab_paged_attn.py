"""Kernel row 3 (the paged-attention decode read) of two checkouts of
this repo, timed in one process each, in turns A B B A, on one CUDA card.

    python3 tools/ab_paged_attn.py --a DIR_A --b DIR_B \
        [--lengths 96 1024 4096] [--batch 8]

Each DIR is the root of a checkout: its ``src/repro_torch`` is imported
and its kernels are built into its own ``build/``.  Each turn calls
``paged_attention_cuda`` (the same signature in every checkout that has
it) at minicpm-2b's decode shape (48 heads, G 1, Dh 64, block size 16)
for each length of ``--lengths``, on the operands of ``chip_smoke.py``
phase 13 made from seed 13 on the card (``chip_smoke.paged_pools``):
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


def turn(root: str, lengths, batch: int) -> dict:
    """Times of ``root``'s paged-attention kernel per length."""
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(1, ROOT)
    import torch
    from chip_smoke import (cold_copy_count, cuda_ms, graph_ms,
                            graph_rotation_ms, paged_pool_bytes, paged_pools,
                            paged_tolerance_ok)
    from repro_torch.kernels.paged_attn import kernel as PK
    from repro_torch.kernels.paged_attn import ref as PR

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    by_length = {}
    for L in lengths:
        copies = cold_copy_count(torch, dev, paged_pool_bytes(batch, L))
        q, pools, table, lens = paged_pools(torch, dev, gen, batch, L, copies)
        kp, vp = pools[0]
        fn = lambda: PK.paged_attention_cuda(q, kp, vp, table, lens)
        ok = paged_tolerance_ok(torch, fn(), PR.paged_attention_ref(
            q, kp, vp, table, lens), vp)
        by_length[L] = dict(
            ms=cuda_ms(fn, reps=50), device_ms=graph_ms(torch, fn),
            device_cold_ms=graph_rotation_ms(torch, [
                lambda kp=kp, vp=vp: PK.paged_attention_cuda(q, kp, vp,
                                                             table, lens)
                for kp, vp in pools]),
            copies=copies, within_tolerance=ok)
        del pools, kp, vp
    return {"root": root, "module": PK.__file__, "batch": batch,
            "by_length": by_length}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", required=True, help="root of checkout A")
    ap.add_argument("--b", required=True, help="root of checkout B")
    ap.add_argument("--lengths", type=int, nargs="+", default=[96, 1024, 4096],
                    help="context lengths, one or more")
    ap.add_argument("--batch", type=int, default=8, help="rows")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(os.path.abspath(args.turn), args.lengths,
                              args.batch)), flush=True)
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
             "--batch", str(args.batch), "--turn", root],
            capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["label"] = label
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    ok = all(t["within_tolerance"] for run in runs
             for t in run["by_length"].values())
    per_length = {L: {label: [{k: r["by_length"][L][k] for k in (
        "ms", "device_ms", "device_cold_ms")} for r in runs
        if r["label"] == label] for label in ("A", "B")}
        for L in runs[0]["by_length"]}
    print(json.dumps({"kernel": "paged", "batch": args.batch,
                      "per_length": per_length,
                      "outputs_within_tolerance": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
