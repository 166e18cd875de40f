"""Kernel row 2 (the prepacked general macro GEMM), row 6 (the
unpacked macro GEMM on raw weights), row 5 (the prepacked complex
general macro GEMM) or row 7 (the complex macro GEMM on raw weights) of
two checkouts of this repo, timed in one process each, in turns A B B A,
on one CUDA card.

    python3 tools/ab_general_gemm.py --a DIR_A --b DIR_B \
        [--kernel general|unpacked|complex_general|complex_unpacked] \
        [--m 128] [--kn K N]

Each DIR is the root of a checkout: its ``src/repro_torch`` is imported
and its kernels are built into its own ``build/``.  Each turn times the
kernel at minicpm-2b's four full-width layer GEMMs at M ``--m`` (default
128), or at the one (K, N) of ``--kn`` (``--m 60 --kn 64 2401``: the
64-element DoA spectrum; ``--m 64 --kn 4096 64``: its covariance), on
SMF int8 x made from seed 0 on the card: ``general`` calls
``ccim_matmul_prepacked_general_cuda`` at the prototype design point
(acc_len 16, x_bits (6, 5), dcim_lsb 2048, adc_half 64) on int8 w
(N, K) and planes in [-7, 7]; ``unpacked`` calls
``ccim_matmul_unpacked_cuda`` on raw int8 w (K, N), which has the same
signature in every checkout that has it; ``complex_general`` calls
``ccim_complex_prepacked_general_cuda`` on x_re, x_im, int8 w_re, w_im
(N, K) and planes (2, N, K) in [-7, 7] of each side;
``complex_unpacked`` calls ``ccim_complex_unpacked_cuda`` on x_re, x_im
and raw int8 w_re, w_im (K, N) (the complex kernels build in the
prototype's numerics; each signature is the same in every checkout that
has the kernel).  ``ms`` is CUDA events around
one call (host wrapper included), ``device_ms`` CUDA-graph replays (the
kernel alone), both as ``chip_smoke.py`` phase 7 times them.  Every turn
prints one JSON line with a hash of each output; the hashes of A and B
must agree (both compute the macro's integers; a complex kernel's hash
covers Re and Im), or the script exits 1.
The last line holds both checkouts' times side by side.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = dict(acc_len=16, x_bits=(6, 5), dcim_lsb=2048, adc_half=64)


def turn(root: str, kernel: str, m: int, kn=None) -> dict:
    """Times and output hashes of ``root``'s kernel ``kernel``."""
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(1, ROOT)
    import torch
    from chip_smoke import FULL_SHAPES, cuda_ms, graph_ms
    from repro_torch.kernels.ccim_complex import kernel as CK
    from repro_torch.kernels.ccim_matmul import kernel as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    i8 = lambda lo, hi, *shape: torch.randint(
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int8)
    shapes, tot = {}, dict(ms=0.0, device_ms=0.0)
    for sname, (k, n) in ({f"k{kn[0]}_n{kn[1]}": kn} if kn
                          else FULL_SHAPES).items():
        if kernel == "unpacked":
            x, w = i8(-127, 128, m, k), i8(-127, 128, k, n)
            fn = lambda: K.ccim_matmul_unpacked_cuda(x, w)
        elif kernel == "complex_unpacked":
            xr, xi = i8(-127, 128, m, k), i8(-127, 128, m, k)
            wr, wi = i8(-127, 128, k, n), i8(-127, 128, k, n)
            fn = lambda: CK.ccim_complex_unpacked_cuda(xr, xi, wr, wi)
        elif kernel == "complex_general":
            sides = [(i8(-127, 128, m, k), i8(-127, 128, n, k),
                      i8(-7, 8, 2, n, k)) for _ in range(2)]
            (xr, wr, pr), (xi, wi, pi) = sides
            fn = lambda: CK.ccim_complex_prepacked_general_cuda(
                xr, xi, wr, pr, wi, pi)
        else:
            x, w, planes = i8(-127, 128, m, k), i8(-127, 128, n, k), i8(
                -7, 8, 2, n, k)
            fn = lambda: K.ccim_matmul_prepacked_general_cuda(x, w, planes,
                                                              **META)
        out = fn()
        digest = hashlib.sha256(b"".join(
            o.cpu().numpy().tobytes() for o in (
                out if isinstance(out, tuple) else (out,)))).hexdigest()
        t = dict(ms=cuda_ms(fn, reps=30), device_ms=graph_ms(torch, fn))
        shapes[sname] = dict(t, k=k, n=n, sha256=digest[:16])
        for key in tot:
            tot[key] += t[key]
    module = CK if kernel.startswith("complex") else K
    return {"root": root, "module": module.__file__, "kernel": kernel,
            "m": m,
            "layer_total": tot, "shapes": shapes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", required=True, help="root of checkout A")
    ap.add_argument("--b", required=True, help="root of checkout B")
    ap.add_argument("--kernel",
                    choices=("general", "unpacked", "complex_general",
                             "complex_unpacked"),
                    default="general", help="row 2, 6, 5 or 7")
    ap.add_argument("--m", type=int, default=128, help="rows of x")
    ap.add_argument("--kn", type=int, nargs=2, metavar=("K", "N"),
                    help="one (K, N) instead of the full-width shapes")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(os.path.abspath(args.turn), args.kernel,
                              args.m, args.kn)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    runs = []
    for label, root in (("A", args.a), ("B", args.b), ("B", args.b),
                        ("A", args.a)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--a", args.a,
             "--b", args.b, "--kernel", args.kernel, "--m", str(args.m),
             *(["--kn", *map(str, args.kn)] if args.kn else []),
             "--turn", root], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["label"] = label
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    hashes = {json.dumps({s: v["sha256"] for s, v in r["shapes"].items()})
              for r in runs}
    summary = {label: [r["layer_total"] for r in runs if r["label"] == label]
               for label in ("A", "B")}
    print(json.dumps({"kernel": args.kernel, "m": args.m, "kn": args.kn,
                      "per_layer": summary,
                      "outputs_equal": len(hashes) == 1}))
    return 0 if len(hashes) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
