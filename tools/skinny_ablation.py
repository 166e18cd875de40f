"""What holds kernel row 1 (the prepacked skinny macro GEMM) above its
byte bound: the committed source and textual variants of it, built side
by side and timed cold per full-width layer on one CUDA card.

    python3 tools/skinny_ablation.py [--m 1 4 8 16 32]

Variants of ``ccim_prepacked_skinny.cu`` (each one substitution or a few,
compiled with nvcc for sm_90a into ``build/skinny_ablation/``):

  kernel        the source as committed
  no_memset     no zeroing of out where tiles are cut (wrong results
                there: timing only)
  no_compute    loads, waits and stores only (timing only)
  stream_only   no_compute and no_memset: the ring and the launch alone
  ring3_w8      three stages a warp ring, 8 warps a block at M <= 8 and 6
                above (the shared memory they fit)
  w8            8 warps a block at M <= 8 (two stages each)
  no_prefetch   cp.async without the L2 prefetch of 256 bytes

Each is called through the same C entry point as the committed library
on random SMF int8 x, w and planes in [-7, 7] at the prototype design
point (acc_len 16, x_bits (6, 5), dcim_lsb 2048, adc_half 64) at
minicpm-2b's four layer GEMMs, and timed as ``chip_smoke.py`` phase 7
times ``device_cold_ms`` (CUDA-graph replays rotating over distinct
weight copies).  One JSON line per M and variant: the layer's cold
device ms, per shape, and whether the output equals the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src/repro_torch/kernels/ccim_matmul/csrc")
SOURCE = os.path.join(CSRC, "ccim_prepacked_skinny.cu")
OUT = os.path.join(ROOT, "build", "skinny_ablation")

MEMSET = ("  if (split) {\n    const cudaError_t e =",
          "  if (false) {\n    const cudaError_t e =")
COMPUTE = ("    compute(t);\n", "    if (a.M < 0) compute(t);\n")
VARIANTS = {
    "kernel": [],
    "no_memset": [MEMSET],
    "no_compute": [COMPUTE],
    "stream_only": [MEMSET, COMPUTE],
    "ring3_w8": [("kWarps = TG == 1 ? 12 : 8;", "kWarps = TG == 1 ? 8 : 6;"),
                 ("kStages = 2;", "kStages = 3;")],
    "w8": [("kWarps = TG == 1 ? 12 : 8;", "kWarps = TG == 1 ? 8 : 8;")],
    "no_prefetch": [(".global.L2::256B [", ".global [")],
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
        fn = ctypes.CDLL(so).ccim_prepacked_skinny
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[1, 4, 8, 16, 32])
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    from chip_smoke import FULL_SHAPES, cold_copies, graph_rotation_ms
    from repro_torch.kernels.ccim_matmul import kernel as K

    fns = build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    copies = cold_copies(torch, dev, gen, 2)
    meta = dict(acc_len=16, x_bits=(6, 5), dcim_lsb=2048, adc_half=64)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def call(fn, x, w, planes, out):
        err = fn(x.data_ptr(), w.data_ptr(), planes.data_ptr(),
                 out.data_ptr(), x.shape[0], w.shape[0], x.shape[1], 2,
                 6 | 5 << 4, 11, 64, 16, None, stream())
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    for m in args.m:
        xs, outs, want = {}, {}, {}
        for s, (k, n) in FULL_SHAPES.items():
            xs[s] = torch.randint(-127, 128, (m, k), generator=gen,
                                  device=dev, dtype=torch.int8)
            outs[s] = torch.empty((m, n), dtype=torch.int32, device=dev)
            want[s] = K.ccim_matmul_prepacked_plain(xs[s], *copies[s][0],
                                                    **meta)
        for name, fn in fns.items():
            shapes = {}
            for s in FULL_SHAPES:
                call(fn, xs[s], *copies[s][0], outs[s])
                equal = bool(torch.equal(outs[s], want[s]))
                ms = graph_rotation_ms(torch, [
                    lambda c=c, s=s: call(fn, xs[s], *c, outs[s])
                    for c in copies[s]])
                shapes[s] = {"device_cold_ms": ms, "equal": equal}
            print(json.dumps({
                "m": m, "variant": name,
                "device_cold_ms": sum(v["device_cold_ms"]
                                      for v in shapes.values()),
                "shapes": shapes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
