"""One GEMM kernel row of two checkouts of this repo, timed in one
process each, in turns A B B A, on one CUDA card: row 1 (the prepacked
skinny macro GEMM, decode), 2 (the prepacked general one, prefill), 4
(the prepacked complex skinny one), 5 (the prepacked complex general
one), 6 (the unpacked one on raw weights), 7 (the complex one on raw
weights) or 8 (the W8A8 GEMM).

    python3 tools/ab_general_gemm.py --a DIR_A --b DIR_B \
        [--kernel skinny|general|complex_skinny|complex_general|unpacked|\
complex_unpacked|int8] [--m 128 [M ...]] [--kn K N]

Each DIR is the root of a checkout: its ``src/repro_torch`` is imported
and its kernels are built into its own ``build/``.  Each turn times the
kernel at minicpm-2b's four full-width layer GEMMs at each M of ``--m``
(default 128; the skinny kernels take M <= 32), or at the one (K, N) of
``--kn`` (``--m 60 --kn 64 2401``: the 64-element DoA spectrum; ``--m 64
--kn 4096 64``: its covariance), on SMF int8 x made from seed 0 on the
card: ``skinny`` and ``general`` call ``ccim_matmul_prepacked_*_cuda``
at the prototype design point (acc_len 16, x_bits (6, 5), dcim_lsb 2048,
adc_half 64) on int8 w (N, K) and planes in [-7, 7]; ``unpacked`` calls
``ccim_matmul_unpacked_cuda`` on raw int8 w (K, N), which has the same
signature in every checkout that has it; ``complex_skinny`` and
``complex_general`` call ``ccim_complex_prepacked_*_cuda`` on x_re,
x_im, int8 w_re, w_im (N, K) and planes (2, N, K) in [-7, 7] of each
side; ``complex_unpacked`` calls ``ccim_complex_unpacked_cuda`` on x_re,
x_im and raw int8 w_re, w_im (K, N) (the complex kernels build in the
prototype's numerics; each signature is the same in every checkout that
has the kernel); ``int8`` calls ``int8_w8a8_cuda(x, w, sx, sw)`` on int8
w (N, K) and float32 scales in [0.5, 1.5) (its hash covers the float32
output).  ``ms`` is CUDA events around one call (host wrapper
included), ``device_ms`` CUDA-graph replays on the same operands (the
kernel alone), both as ``chip_smoke.py`` phase 7 times them, and
``device_cold_ms`` replays rotating over distinct copies of the weights
(``chip_smoke.cold_copy_count``: at least 4 per shape and 4 L2s of
bytes), so that no call finds its weights in L2.  Every turn prints one
JSON line with a hash of each output (on the first weight copy); the
hashes of A and B must agree (both compute the same function; a
complex kernel's hash covers Re and Im), or the script exits 1.  The
last line holds both checkouts' times side by side, per M.
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
KERNELS = ("skinny", "general", "complex_skinny", "complex_general",
           "unpacked", "complex_unpacked", "int8")


def weights(kernel: str, i8, k: int, n: int) -> tuple:
    """One copy of ``kernel``'s weight operands for (K, N)."""
    if kernel == "unpacked":
        return (i8(-127, 128, k, n),)
    if kernel == "int8":
        return i8(-127, 128, n, k), 0.5 + i8(0, 100, n).float() / 100
    if kernel == "complex_unpacked":
        return i8(-127, 128, k, n), i8(-127, 128, k, n)
    side = lambda: (i8(-127, 128, n, k), i8(-7, 8, 2, n, k))
    return side() + side() if kernel.startswith("complex") else side()


def call(kernel: str, xs: tuple, ws: tuple):
    """``kernel`` on activations ``xs`` and weights ``ws``."""
    from repro_torch.kernels.ccim_complex import kernel as CK
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.kernels.int8_matmul import kernel as IK
    if kernel == "int8":
        return IK.int8_w8a8_cuda(xs[0], ws[0], xs[1], ws[1])
    if kernel == "unpacked":
        return K.ccim_matmul_unpacked_cuda(xs[0], ws[0])
    if kernel == "complex_unpacked":
        return CK.ccim_complex_unpacked_cuda(*xs, *ws)
    if kernel.startswith("complex"):
        fn = getattr(CK, f"ccim_complex_prepacked_{kernel[8:]}_cuda")
        return fn(xs[0], xs[1], *ws)
    fn = getattr(K, f"ccim_matmul_prepacked_{kernel}_cuda")
    return fn(xs[0], *ws, **META)


def turn(root: str, kernel: str, ms, kn=None) -> dict:
    """Times and output hashes of ``root``'s kernel ``kernel`` per M."""
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(1, ROOT)
    import torch
    from chip_smoke import (FULL_SHAPES, cold_copy_count, cuda_ms, graph_ms,
                            graph_rotation_ms)
    from repro_torch.kernels.ccim_complex import kernel as CK
    from repro_torch.kernels.ccim_matmul import kernel as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    i8 = lambda lo, hi, *shape: torch.randint(
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int8)
    shapes_kn = {f"k{kn[0]}_n{kn[1]}": tuple(kn)} if kn else FULL_SHAPES
    copies = {}
    for sname, (k, n) in shapes_kn.items():
        first = weights(kernel, i8, k, n)
        nbytes = sum(w.numel() * w.element_size() for w in first)
        copies[sname] = [first] + [weights(kernel, i8, k, n) for _ in
                                   range(cold_copy_count(torch, dev,
                                                         nbytes) - 1)]
    by_m = {}
    for m in ms:
        shapes, tot = {}, dict(ms=0.0, device_ms=0.0, device_cold_ms=0.0)
        for sname, (k, n) in shapes_kn.items():
            xs = tuple(i8(-127, 128, m, k) for _ in
                       range(2 if kernel.startswith("complex") else 1))
            if kernel == "int8":
                xs += (0.5 + i8(0, 100, m).float() / 100,)
            ws = copies[sname]
            fn = lambda: call(kernel, xs, ws[0])
            out = fn()
            digest = hashlib.sha256(b"".join(
                o.cpu().numpy().tobytes() for o in (
                    out if isinstance(out, tuple) else (out,)))).hexdigest()
            t = dict(ms=cuda_ms(fn, reps=30), device_ms=graph_ms(torch, fn),
                     device_cold_ms=graph_rotation_ms(
                         torch, [lambda c=c: call(kernel, xs, c)
                                 for c in ws]))
            shapes[sname] = dict(t, k=k, n=n, copies=len(ws),
                                 sha256=digest[:16])
            for key in tot:
                tot[key] += t[key]
        by_m[m] = {"layer_total": tot, "shapes": shapes}
    from repro_torch.kernels.int8_matmul import kernel as IK
    module = (IK if kernel == "int8" else CK if kernel.startswith("complex")
              else K)
    return {"root": root, "module": module.__file__, "kernel": kernel,
            "by_m": by_m}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", required=True, help="root of checkout A")
    ap.add_argument("--b", required=True, help="root of checkout B")
    ap.add_argument("--kernel", choices=KERNELS, default="general",
                    help="row 1, 2, 4, 5, 6, 7 or 8")
    ap.add_argument("--m", type=int, nargs="+", default=[128],
                    help="rows of x, one or more")
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
             "--b", args.b, "--kernel", args.kernel,
             "--m", *map(str, args.m),
             *(["--kn", *map(str, args.kn)] if args.kn else []),
             "--turn", root], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["label"] = label
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    hashes = {json.dumps({m: {s: v["sha256"] for s, v in r["shapes"].items()}
                          for m, r in run["by_m"].items()}) for run in runs}
    per_layer = {m: {label: [r["by_m"][m]["layer_total"] for r in runs
                             if r["label"] == label] for label in ("A", "B")}
                 for m in runs[0]["by_m"]}
    print(json.dumps({"kernel": args.kernel, "m": args.m, "kn": args.kn,
                      "per_layer": per_layer,
                      "outputs_equal": len(hashes) == 1}))
    return 0 if len(hashes) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
