#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch`` and drives its
main path: packed-CIM lock-step serving of full-width minicpm-2b.  Each
phase prints one JSON line; the script exits non-zero at the first
failure.  Phases:

  1. device: the card's name and power limit, and the kernel build time;
  2. kernels vs their plain PyTorch version at minicpm-2b's full-width
     (K, N) shapes, int32 outputs compared with torch.equal;
  3. the same over every design point (n_dcim 0-6 x ADC 7/8/9 b x
     acc_len 8/16/32/64) on a ragged shape, plus analog-subset serving of
     a hybrid pack;
  4. full-width serve (40 layers) through the kernels, with the launch
     counts that show every macro GEMM went through them;
  5. the same serve through the plain version on the same weights:
     tokens and last logits must be identical;
  6. a torch.profiler trace of three full-width decode steps: step wall
     time, device busy time and the kernels that take it;
  7. per-kernel CUDA-event times at the full-width shapes beside the
     plain version, torch._int_mm (a labelled yardstick that computes a
     different function) and the bound from bytes and operations.

The line before the last is the kernels table; the last line is the
device record.  Needs a CUDA device: without one it exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM data-sheet peaks (dense): HBM bytes/s and int8 operations/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12

# minicpm-2b full-width macro GEMMs of one layer, (K, N), heads padded to 48
FULL_SHAPES = {"qkv": (2304, 9216), "wo": (3072, 2304),
               "gate_up": (2304, 11520), "w2": (5760, 2304)}
SKINNY_MS, GENERAL_MS = (1, 4, 32), (33, 128, 512)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port is missing ({SRC}/repro_torch); run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.core import engine
    from repro_torch.core.ccim import CCIMConfig, DEFAULT_CONFIG, quantize_smf
    from repro_torch.core.ccim import smf_scale
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.launch.serve import serve
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    dev = torch.device("cuda")
    t_start = time.time()

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    K.load_kernels()
    build_s = time.time() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln][:8]
             for n, log in K.build_info.get("ptxas", {}).items()}
    emit({"phase": "build", "seconds": build_s,
          "built": K.build_info.get("built"), "ptxas": ptxas,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def smf_ints(shape):
        v = torch.randn(shape, generator=gen, device=dev)
        return quantize_smf(v, smf_scale(v, dim=-1, keepdim=True))

    def run(x, p, cfg, use_kernel):
        return engine.packed_cim_matmul_int(x, p, cfg=cfg,
                                            use_kernel=use_kernel)

    max_err = {"skinny": 0, "general": 0}

    def compare(x, p, cfg, tag):
        y_k = run(x, p, cfg, True)
        y_p = run(x, p, cfg, False)
        torch.cuda.synchronize()
        name = "skinny" if x.shape[0] <= K.SKINNY_M else "general"
        err = int((y_k.long() - y_p.long()).abs().max())
        max_err[name] = max(max_err[name], err)
        check(y_k.dtype == torch.int32 and torch.equal(y_k, y_p),
              f"{name} kernel != plain at {tag}: max |diff| {err}")

    # -- 2. full-width shapes ----------------------------------------------
    packs = {}
    for sname, (k, n) in FULL_SHAPES.items():
        wq = smf_ints((n, k)).t()
        packs[sname] = engine.pack_quantized_cim_weights(
            wq, torch.ones((1, n), device=dev), DEFAULT_CONFIG)
        for m in SKINNY_MS + GENERAL_MS:
            compare(smf_ints((m, k)), packs[sname], DEFAULT_CONFIG,
                    f"{sname} M={m}")
    emit({"phase": "full_width_shapes", "ok": True,
          "shapes": {s: list(v) for s, v in FULL_SHAPES.items()},
          "m": list(SKINNY_MS + GENERAL_MS), "max_abs_err": max_err})

    # -- 3. design-point sweep ----------------------------------------------
    n_points = 0
    for acc in (8, 16, 32, 64):
        w_raw = torch.randint(-127, 128, (1000, 300), generator=gen,
                              device=dev, dtype=torch.int32)
        for nd in range(7):
            for adc in (7, 8, 9):
                cfg = CCIMConfig(n_dcim_products=nd, adc_bits=adc,
                                 acc_len=acc)
                p = engine.pack_quantized_cim_weights(
                    w_raw, torch.ones((1, 300), device=dev), cfg)
                for m in (3, 77):
                    x = torch.randint(-127, 128, (m, 1000), generator=gen,
                                      device=dev, dtype=torch.int32)
                    compare(x, p, cfg, f"n_dcim={nd} adc={adc} L={acc} M={m}")
                    n_points += 1
        hybrid = CCIMConfig(n_dcim_products=3, acc_len=acc)
        p = engine.pack_quantized_cim_weights(
            w_raw, torch.ones((1, 300), device=dev), hybrid)
        for adc in (5, 7, 9):
            subset = CCIMConfig(n_dcim_products=0, adc_bits=adc, acc_len=acc)
            for m in (3, 77):
                x = torch.randint(-127, 128, (m, 1000), generator=gen,
                                  device=dev, dtype=torch.int32)
                compare(x, p, subset, f"analog subset adc={adc} L={acc} M={m}")
                n_points += 1
    emit({"phase": "design_sweep", "ok": True, "calls": n_points,
          "max_abs_err": max_err})

    # -- 4./5. full-width serve: kernels, then the plain version -------------
    cfg_full = get_config("minicpm-2b")
    batch, prompt_len, gen_len = 4, 32, 16
    params = lm.init(0, cfg_full, device=dev)
    runs = {}
    for label, use_kernel in (("kernel", None), ("plain", False)):
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        toks, stats = serve("minicpm-2b", smoke=False, batch=batch,
                            prompt_len=prompt_len, gen=gen_len, cim=True,
                            params=params, use_kernel=use_kernel,
                            return_stats=True)
        launches = {
            "general": K.ccim_matmul_prepacked_general_cuda.launches,
            "skinny": K.ccim_matmul_prepacked_skinny_cuda.launches}
        logits = stats.pop("last_logits")
        runs[label] = (toks, logits, launches)
        emit({"phase": f"serve_{label}", "n_layers": stats["n_layers"],
              "d_model": cfg_full.d_model, "vocab": cfg_full.vocab_size,
              "batch": batch, "prompt_len": prompt_len, "gen": gen_len,
              "pack_s": stats["pack_s"], "prefill_s": stats["prefill_s"],
              "decode_s": stats["decode_s"],
              "decode_tok_s": stats["decode_tok_s"],
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": launches, "tokens_row0": toks[0].tolist()})
        check(toks.shape == (batch, gen_len), f"tokens shape {toks.shape}")
        check(bool(((toks >= 0) & (toks < cfg_full.vocab_size)).all()),
              "token ids out of range")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
    n_gemm = 4 * cfg_full.n_layers          # fused QKV, wo, gate-up, w2
    k_launch = runs["kernel"][2]
    check(k_launch["general"] == n_gemm,
          f"prefill launched {k_launch['general']} general kernels, "
          f"expected {n_gemm}")
    check(k_launch["skinny"] == n_gemm * (gen_len - 1),
          f"decode launched {k_launch['skinny']} skinny kernels, expected "
          f"{n_gemm} per step x {gen_len - 1}")
    check(runs["plain"][2] == {"general": 0, "skinny": 0},
          "the plain run launched kernels")
    check((runs["kernel"][0] == runs["plain"][0]).all(),
          "kernel and plain runs generated different tokens")
    check(torch.equal(runs["kernel"][1], runs["plain"][1]),
          "kernel and plain runs gave different logits")
    emit({"phase": "serve_compare", "ok": True, "tokens_equal": True,
          "logits_equal": True})

    # -- 6. where a full-width decode step spends its device time ----------
    cfg_cim = dataclasses.replace(cfg_full, cim_mode=True)
    with torch.inference_mode():
        packed = lm.pack_cim_params(params, cfg_cim, dev)
        del params
        cache = lm.init_cache(cfg_cim, batch, prompt_len + gen_len,
                              device=dev)
        tok = torch.zeros((batch, prompt_len), dtype=torch.int64, device=dev)
        _, cache = lm.prefill(packed, cfg_cim, tok, cache)
        tok = tok[:, :1]
        lm.decode_step(packed, cfg_cim, tok, cache)      # warm
        torch.cuda.synchronize()
        steps = 3
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                _, cache = lm.decode_step(packed, cfg_cim, tok, cache)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    del packed, cache
    dev_us, host_us, aten_calls = {}, {}, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0:
            dev_us[e.key] = dev_us.get(e.key, 0) + t
        if e.key.startswith("aten::"):
            host_us[e.key] = e.self_cpu_time_total
            aten_calls += e.count
    busy_ms = sum(dev_us.values()) / 1e3 / steps
    per_step = lambda d: {k[:60]: v / 1e3 / steps for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:8]}
    emit({"phase": "decode_profile", "steps": steps,
          "step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
          "aten_calls_per_step": aten_calls / steps,
          "top_device_ms_per_step": per_step(dev_us),
          "top_host_self_ms_per_step": per_step(host_us)})

    # -- 7. per-kernel times --------------------------------------------------
    x_bits = (6, 5)                          # the prototype's top-3 split
    n_j = len(x_bits)
    meta = dict(acc_len=DEFAULT_CONFIG.acc_len, x_bits=x_bits,
                dcim_lsb=DEFAULT_CONFIG.dcim_lsb,
                adc_half=DEFAULT_CONFIG.adc_half_range)
    wrapper = {"skinny": K.ccim_matmul_prepacked_skinny_cuda,
               "general": K.ccim_matmul_prepacked_general_cuda}
    rows = {}
    for name, m in (("skinny", 4), ("general", 128)):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   bytes=0, ops=0)
        per_shape = {}
        for sname, (k, n) in FULL_SHAPES.items():
            p = packs[sname]
            kp = p.kernel_w.shape[1]
            x = smf_ints((m, kp)).to(torch.int8)
            w, planes = p.kernel_w, p.kernel_planes
            ms = cuda_ms(lambda: wrapper[name](x, w, planes, **meta),
                         reps=30)
            plain = cuda_ms(
                lambda: K.ccim_matmul_prepacked_plain(x, w, planes, **meta),
                reps=5)
            # torch._int_mm: int8 GEMM without the per-chunk clip, M >= 17
            xi = torch.zeros((max(m, 32), kp), dtype=torch.int8, device=dev)
            lib = cuda_ms(lambda: torch._int_mm(xi, p.kernel_w.t()), reps=30)
            nbytes = m * kp + (1 + n_j) * n * kp + 4 * m * n
            nops = 2 * m * n * kp * (1 + n_j)
            bound = 1e3 * max(nbytes / HBM_BYTES_S, nops / INT8_OPS_S)
            per_shape[sname] = dict(m=m, k=k, n=n, ms=ms, plain_ms=plain,
                                    library_ms=lib, bound_ms=bound)
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("bound_ms", bound), ("library_ms", lib),
                           ("bytes", nbytes), ("ops", nops)):
                tot[key] += v
        emit({"phase": f"times_{name}", "m": m, "shapes": per_shape,
              "layer_total": tot})
        rows[name] = tot
    src = "src/repro_torch/kernels/ccim_matmul/csrc/"
    table = []
    for name, entry, replaces in (
            ("skinny", "ccim_prepacked_skinny.cu",
             "src/repro/kernels/ccim_matmul/kernel.py:275"),
            ("general", "ccim_prepacked_general.cu",
             "src/repro/kernels/ccim_matmul/kernel.py:157")):
        t = rows[name]
        table.append({
            "name": f"ccim_matmul_prepacked_{name}",
            "route": "cuda", "source": src + entry, "replaces": replaces,
            "launches": k_launch[name], "max_abs_err": max_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes"] / HBM_BYTES_S
                         >= t["ops"] / INT8_OPS_S else "operations"),
            "library_ms": t["library_ms"]})
    emit({"phase": "done", "seconds": time.time() - t_start})
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
