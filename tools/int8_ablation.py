"""What holds kernel row 8 (the W8A8 GEMM) above its byte bound: the
committed source and textual variants of it, built side by side and timed
cold per full-width layer on one CUDA card.

    python3 tools/int8_ablation.py [--m 4 128]

Variants of ``int8_w8a8.cu`` (each one substitution or a few, compiled
with nvcc for sm_90a into ``build/int8_ablation/``):

  kernel        the source as committed
  no_reduce     every block sums its share over its own partial tile
                `splits` times, local loads in place of distributed
                shared memory (wrong results where K is split: timing
                only)
  no_epilogue   no parked tile, no reduction, no stores (timing only)
  no_mma        the ring and the epilogue without the wgmmas (timing
                only)
  stream_only   no_mma and no_epilogue: the TMA ring and the launch alone

Each is called through the same C entry point as the committed library,
under the plan ``kernel.py::plan`` gives, on random int8 x and w and
float32 scales at minicpm-2b's four layer GEMMs, and timed as
``chip_smoke.py`` phase 21 times ``device_cold_ms`` (CUDA-graph replays
rotating over distinct weight copies).  One JSON line per M and variant:
the layer's cold device ms, per shape, and whether the output equals the
plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src/repro_torch/kernels/int8_matmul/csrc")
SOURCE = os.path.join(CSRC, "int8_w8a8.cu")
OUT = os.path.join(ROOT, "build", "int8_ablation")

REDUCE = [("b < splits ? b : 0);", "split);")]
EPILOGUE = [("  if (warp < CONSUMERS / 32) {\n    const int row",
             "  if (M < 0) {\n    const int row"),
            ("for (int v = lo + threadIdx.x; v < hi && n < N;",
             "for (int v = hi; v < hi && n < N;")]
MMA = [("        sm90::MmaS8<TOK>::mma(",
        "        if (M < 0) sm90::MmaS8<TOK>::mma(")]
VARIANTS = {
    "kernel": [],
    "no_reduce": REDUCE,
    "no_epilogue": EPILOGUE,
    "no_mma": MMA,
    "stream_only": MMA + EPILOGUE,
}
NVCC = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC")


def build() -> dict:
    """Compile every variant in parallel -> {name: bound entry point}."""
    os.makedirs(OUT, exist_ok=True)
    base = open(SOURCE).read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = base
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in {SOURCE}")
            src = src.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(OUT, f"{name}.so")
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC, "-I", CSRC, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        fn = ctypes.CDLL(so).int8_w8a8
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[4, 128])
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    from chip_smoke import FULL_SHAPES, cold_copy_count, graph_rotation_ms
    from repro_torch.kernels.int8_matmul import kernel as IK

    fns = build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    copies = {s: [(torch.randint(-127, 128, (n, k), generator=gen,
                                 device=dev, dtype=torch.int8),
                   torch.rand(n, generator=gen, device=dev) + 0.5)
                  for _ in range(cold_copy_count(torch, dev, n * k))]
              for s, (k, n) in FULL_SHAPES.items()}
    sms = IK.sm_count(dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def call(fn, x, sx, w, sw, out, p):
        err = fn(x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                 out.data_ptr(), x.shape[0], w.shape[0], x.shape[1], p.tok,
                 p.splits, p.per_split, p.ring, stream())
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    for m in args.m:
        for name, fn in fns.items():
            shapes = {}
            for s, (k, n) in FULL_SHAPES.items():
                x = torch.randint(-127, 128, (m, k), generator=gen,
                                  device=dev, dtype=torch.int8)
                sx = torch.rand(m, generator=gen, device=dev) + 0.5
                out = torch.empty((m, n), dtype=torch.float32, device=dev)
                p = IK.plan(m, n, k, sms)
                call(fn, x, sx, *copies[s][0], out, p)
                equal = bool(torch.equal(
                    out, IK.int8_w8a8_plain(x, copies[s][0][0], sx,
                                            copies[s][0][1])))
                ms = graph_rotation_ms(torch, [
                    lambda c=c: call(fn, x, sx, *c, out, p)
                    for c in copies[s]])
                shapes[s] = {"device_cold_ms": ms, "equal": equal,
                             "splits": p.splits, "ring": p.ring}
            print(json.dumps({
                "m": m, "variant": name,
                "device_cold_ms": sum(v["device_cold_ms"]
                                      for v in shapes.values()),
                "shapes": shapes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
