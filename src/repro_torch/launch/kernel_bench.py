"""Kernel bench: emulation fidelity and speed of the macro GEMMs.

Twin of ``benchmarks/kernel_bench.py`` (the "kernels" entry of the
reference's ``benchmarks/run.py``): the same rows, names and parity
asserts, printed as JSON lines on stdout (one header line first).  It
writes no file unless given ``--out``.  Times are medians of CUDA-event
timings of one call on the card (host clock on the CPU), in
microseconds, each call including its host-side wrapper (a graph
replay for the decode-shape pairs, below).

Operands, die and noise key are the reference's draws (``core/prng.py``:
``PRNGKey(seed)``, its split, ``normal`` and ``randint``), so the two
noisy rows (``bit_true_emulation`` on the die of ``fabricate(key)``,
``fast_emulation``) compute the reference's outputs, noise included, and
their errors are the reference's.  With noise the GEMMs run in torch, off
the kernels, as the reference's leave its Pallas kernels.

Differences from the reference:
  * the kernel rows (``decode_skinny_pallas``, ``complex_fused_kernel``,
    ``decode_complex_fused_prepacked``) time the port's CUDA kernels on
    the card where the reference timed its Pallas kernels on a TPU; on
    the CPU they prove parity only (``us`` null), as the reference does
    off the TPU.  The decode rows compare the routes a caller gets:
    per-call weight conditioning (the unpacked kernel on the card)
    against packed weights (the skinny prepacked kernel), with the
    reference's floor ``DECODE_SPEEDUP_FLOOR``;
  * the two routes of each decode-shape ratio (the floor's pair, the
    fused QKV pair, the fused complex pair) are each captured into a
    CUDA graph on the card and replayed, the port's counterpart of the
    reference's jitted routes (timed op by op, the host's dispatch of
    their small ops sets both per-call times, and the floor's ratio
    fell from 1.22-1.25x to 1.04x on a slower host), with their calls
    interleaved, because a shared host's speed drifts between two runs
    of 16 calls (the reference takes the minimum of sequential runs
    instead);
  * ``--scale card`` runs the decode rows at minicpm-2b's fused QKV width
    and adds the W8A8 row at minicpm-2b's four full-width layer GEMMs
    (fused QKV, wo, fused gate-up, w2) at M 4 and M 128, each held to its
    plain version bit for bit.  Their operands are normals under
    ``fold_in(key, m)`` (the reference has no such rows).

    PYTHONPATH=src python -m repro_torch.launch.kernel_bench --scale card
    PYTHONPATH=src python -m repro_torch.launch.kernel_bench --device cpu
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, List, Optional

import torch

from .. import resolve_device
from ..core import prng
from ..core.ccim import DEFAULT_CONFIG, cim_matmul, cim_matmul_int, fabricate
from ..core.complex_mac import complex_cim_matmul, complex_cim_matmul_int
from ..core.engine import pack_cim_weights, pack_complex_cim_weights
from ..kernels.ccim_complex.ops import ccim_complex_matmul_int
from ..kernels.ccim_complex.ref import ccim_complex_matmul_ref
from ..kernels.ccim_matmul.ref import ccim_matmul_ref
from ..kernels.int8_matmul.ops import int8_matmul
from .graphs import StepGraph

# The reference's decode-shape gate: packed weights must beat per-call
# weight conditioning at serving shapes by at least this factor.
DECODE_SPEEDUP_FLOOR = 1.05

# minicpm-2b's four full-width macro GEMMs of one layer, (K, N)
MINICPM_LAYER = {"qkv": (2304, 9216), "wo": (3072, 2304),
                 "gate_up": (2304, 11520), "w2": (5760, 2304)}
# decode (M, K, N) of each scale: the reference's, and minicpm-2b's
# fused QKV width split into three projections
DECODE_SHAPE = {"ref": (4, 1024, 256), "card": (4, 2304, 3072)}
INT8_MS = (4, 128)

FIDELITY_SHAPE = (64, 512, 64)


def fidelity_operands(seed: int, device=None):
    """(x, w, macro, key) of the two noisy rows, on ``device``: the
    reference's ``normal`` operands under the halves of ``split(key)``
    and its die ``fabricate(key)``, ``key = PRNGKey(seed)`` also the
    noise key."""
    M, K, N = FIDELITY_SHAPE
    key = prng.PRNGKey(seed, resolve_device(device))
    k1, k2 = prng.split(key)
    return (prng.normal(k1, (M, K)), prng.normal(k2, (K, N)),
            fabricate(key, DEFAULT_CONFIG), key)


class Bench:
    """Timing and row records of one run."""

    def __init__(self, dev: torch.device, quick: bool,
                 emit: Callable[[dict], None]):
        self.dev, self.quick, self.emit = dev, quick, emit
        self.records: List[dict] = []

    def _once_us(self, fn):
        """(microseconds of one call, its result): CUDA events on the
        card, the host clock on the CPU."""
        if self.dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            return 1e3 * a.elapsed_time(b), out
        t0 = time.perf_counter()
        out = fn()
        return 1e6 * (time.perf_counter() - t0), out

    def time_us(self, fn, iters: int, warmup: int, heavy: bool = False):
        """(median microseconds of one call, the last call's result).
        ``--quick`` times a heavy row once without a warm-up."""
        if self.quick and heavy:
            iters, warmup = 1, 0
        for _ in range(warmup):
            fn()
        ts, out = [], None
        for _ in range(iters):
            t, out = self._once_us(fn)
            ts.append(t)
        return statistics.median(ts), out

    def time_pair_us(self, fa, fb, iters: int, warmup: int):
        """``time_us`` of two routes whose ratio is recorded.  On the card
        each route is captured into a CUDA graph and replayed, as the
        reference times each route as one jitted program: eagerly, the
        host's dispatch of the routes' small ops would set both per-call
        times at decode shapes.  The calls are interleaved (a b, then b
        a) so that a drift of the host's speed falls on both alike.
        Returns ((us_a, out_a), (us_b, out_b))."""
        if self.dev.type == "cuda":
            fa, fb = StepGraph(fa, self.dev), StepGraph(fb, self.dev)
        for _ in range(warmup):
            fa()
            fb()
        ts = {0: [], 1: []}
        outs = [None, None]
        for i in range(iters):
            for j in ((0, 1) if i % 2 == 0 else (1, 0)):
                t, outs[j] = self._once_us((fa, fb)[j])
                ts[j].append(t)
        return ((statistics.median(ts[0]), outs[0]),
                (statistics.median(ts[1]), outs[1]))

    def record(self, op: str, shape, us: Optional[float],
               speedup: Optional[float] = None, note: str = "") -> None:
        row = dict(name=f"kern.{op}", op=op, shape=list(shape), us=us,
                   speedup_vs_prev=speedup, note=note)
        self.records.append(row)
        self.emit(row)


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


def run(seed: int = 0, device=None, scale: str = "ref", quick: bool = False,
        emit: Callable[[dict], None] = lambda row: print(json.dumps(row),
                                                         flush=True)
        ) -> List[dict]:
    """Run every row; returns the row records.  Raises AssertionError on
    a parity failure and SystemExit below the decode floor."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DEFAULT_CONFIG
    on_card = dev.type == "cuda"
    B = Bench(dev, quick, emit)
    key = prng.PRNGKey(seed, dev)
    k1, k2 = prng.split(key)
    kk = prng.split(key, 4)
    rand_q = lambda k, *s: prng.randint(k, s, -127, 128).clamp(-127, 127)

    # ---- fidelity: bit-true oracle vs fast, with the analog noise --------
    M, K, N = FIDELITY_SHAPE
    x, w, macro, _ = fidelity_operands(seed, dev)
    us_bit, y_bit = B.time_us(lambda: cim_matmul(
        x, w, cfg, key, fidelity="bit_true", macro=macro), 2, 1, heavy=True)
    us_fast, y_fast = B.time_us(lambda: cim_matmul(x, w, cfg, key), 2, 1)
    ref = x @ w
    fs = float(x.abs().max() * w.abs().max() * K)
    err_bit = float((y_bit - ref).abs().max()) / fs
    err_fast = float((y_fast - ref).abs().max()) / fs
    B.record("bit_true_emulation", (M, K, N), us_bit,
             note=f"max FS-rel err {err_bit:.4f}; analog noise of the "
             "reference's key (SAR comparator), torch off the kernels")
    B.record("fast_emulation", (M, K, N), us_fast, us_bit / us_fast,
             f"vs bit_true oracle; max FS-rel err {err_fast:.4f}; analog "
             "noise of the reference's key (matched Gaussian), torch off "
             "the kernels")

    # ---- fast-fidelity GEMM: matmul-ized vs elementwise broadcast --------
    M2, K2, N2 = 256, 1024, 256
    qx2, qw2 = rand_q(k1, M2, K2), rand_q(k2, K2, N2)
    us_bc, y_bc = B.time_us(lambda: cim_matmul_int(
        qx2, qw2, cfg, fidelity="fast_broadcast"), 3, 1, heavy=True)
    us_mm, y_mm = B.time_us(lambda: cim_matmul_int(
        qx2, qw2, cfg, use_kernel=False), 8, 2)
    assert torch.equal(y_bc, y_mm), "fast GEMM != broadcast fast path"
    B.record("fast_gemm_broadcast", (M2, K2, N2), us_bc,
             note="legacy elementwise-broadcast fast path")
    B.record("fast_gemm_matmulized", (M2, K2, N2), us_mm, us_bc / us_mm,
             "vs broadcast fast path (bit-identical)")

    # ---- decode shape: per-call conditioning vs packed weights -----------
    Md, Kd, Nd = DECODE_SHAPE[scale]
    xd, wd = prng.normal(k1, (Md, Kd)), prng.normal(k2, (Kd, Nd))
    packed = pack_cim_weights(wd, cfg)
    (us_unp, y_unp), (us_pk, y_pk) = B.time_pair_us(
        lambda: cim_matmul(xd, wd, cfg), lambda: cim_matmul(xd, packed, cfg),
        16, 4)
    assert torch.equal(y_unp, y_pk), "packed != per-call conditioning"
    B.record("decode_gemm_unpacked", (Md, Kd, Nd), us_unp,
             note="per-call weight conditioning"
             + (" (unpacked kernel)" if on_card else ""))
    B.record("decode_gemm_prepacked", (Md, Kd, Nd), us_pk, us_unp / us_pk,
             "vs per-call weight conditioning (bit-identical)"
             + ("; skinny prepacked kernel" if on_card else "")
             + f"; floor {DECODE_SPEEDUP_FLOOR}x")
    if us_unp / us_pk < DECODE_SPEEDUP_FLOOR:
        raise SystemExit(
            f"decode-shape prepacked regression: {us_unp / us_pk:.2f}x < "
            f"{DECODE_SPEEDUP_FLOOR}x floor at {Md}x{Kd}x{Nd} (packing "
            "must beat per-call conditioning at serving shapes)")

    # ---- horizontal fusion at decode shape: one wide GEMM vs three -------
    w3s = [prng.normal(k, (Kd, Nd)) for k in prng.split(k2, 3)]
    pk3 = [pack_cim_weights(v, cfg) for v in w3s]
    pk_f = pack_cim_weights(torch.cat(w3s, dim=1), cfg)
    (us_sep, y_sep), (us_fus, y_fus) = B.time_pair_us(
        lambda: torch.cat([cim_matmul(xd, p, cfg) for p in pk3], dim=1),
        lambda: cim_matmul(xd, pk_f, cfg), 16, 4)
    assert torch.equal(y_sep, y_fus), "fused QKV != three calls"
    B.record("decode_gemm_3x_unfused", (Md, Kd, 3 * Nd), us_sep,
             note="three per-projection prepacked calls (QKV-shaped)")
    B.record("decode_gemm_fused_qkv", (Md, Kd, 3 * Nd), us_fus,
             us_sep / us_fus, "one wide fused GEMM vs 3 skinny calls "
             "(bit-identical per segment)")

    # ---- skinny prepacked kernel at decode shape -------------------------
    qxd = rand_q(k1, Md, Kd)
    us_sk, y_sk = B.time_us(lambda: cim_matmul_int(qxd, packed, cfg), 16, 4)
    ok_sk = torch.equal(y_sk, cim_matmul_int(qxd, packed.wq(), cfg,
                                             use_kernel=False))
    B.record("decode_skinny_pallas", (Md, Kd, Nd), us_sk if on_card else None,
             note=("skinny prepacked CUDA kernel"
                   if on_card else "parity only: plain version")
             + " vs the fast GEMM on raw weights: "
             + ("bit-identical" if ok_sk else "MISMATCH"))
    assert ok_sk, "skinny prepacked kernel diverged from the reference"

    # ---- complex GEMM: matmul-ized 4-pass vs broadcast 4-pass ------------
    cxr, cxi = rand_q(kk[0], M2, K2), rand_q(kk[1], M2, K2)
    cwr, cwi = rand_q(kk[2], K2, N2), rand_q(kk[3], K2, N2)
    us_cb, y_cb = B.time_us(lambda: complex_cim_matmul_int(
        cxr, cxi, cwr, cwi, cfg, fidelity="fast_broadcast"), 2, 1,
        heavy=True)
    us_cm, y_cm = B.time_us(lambda: complex_cim_matmul_int(
        cxr, cxi, cwr, cwi, cfg, use_kernel=False), 6, 2)
    assert _equal(y_cb, y_cm), "complex GEMM != broadcast 4-pass"
    B.record("complex_gemm_broadcast", (M2, K2, N2), us_cb,
             note="complex, 4 broadcast sub-MAC passes")
    B.record("complex_gemm_matmulized", (M2, K2, N2), us_cm, us_cb / us_cm,
             "vs broadcast 4-pass (bit-identical)")

    # ---- fused single-pass complex kernel --------------------------------
    Mc, Kc, Nc = 16, 64, 16
    fxr, fxi = rand_q(kk[0], Mc, Kc), rand_q(kk[1], Mc, Kc)
    fwr, fwi = rand_q(kk[2], Kc, Nc), rand_q(kk[3], Kc, Nc)
    ok = _equal(ccim_complex_matmul_int(fxr, fxi, fwr, fwi),
                ccim_complex_matmul_ref(fxr, fxi, fwr, fwi))
    if on_card:
        us_cf, y_cf = B.time_us(lambda: ccim_complex_matmul_int(
            cxr, cxi, cwr, cwi), 8, 2)
        ok = ok and _equal(y_cf, ccim_complex_matmul_ref(cxr, cxi, cwr, cwi))
        B.record("complex_fused_kernel", (M2, K2, N2), us_cf, us_cm / us_cf,
                 "unpacked fused complex CUDA kernel vs matmul-ized 4-pass "
                 "(bit-identical)" + ("" if ok else "; MISMATCH"))
    else:
        B.record("complex_fused_kernel", (Mc, Kc, Nc), None, None,
                 "parity only: fused Re+Im plain version vs the 4-call "
                 "reference: " + ("bit-identical" if ok else "MISMATCH"))
    assert ok, "fused complex kernel diverged from the 4-call reference"

    # ---- decode-shaped fused complex kernel (skinny prepacked) -----------
    Mcd, Kcd, Ncd = 4, 256, 128
    cpk = pack_complex_cim_weights(prng.normal(kk[0], (Kcd, Ncd)),
                                   prng.normal(kk[1], (Kcd, Ncd)), cfg)
    cxz = torch.complex(prng.normal(kk[2], (Mcd, Kcd)),
                        prng.normal(kk[3], (Mcd, Kcd)))
    (us_cd, y_cd), (us_cr, y_cr) = B.time_pair_us(
        lambda: complex_cim_matmul(cxz, cpk, cfg),
        lambda: complex_cim_matmul(cxz, cpk, cfg, use_kernel=False), 16, 4)
    ok_cd = torch.equal(y_cd, y_cr)
    if on_card:
        B.record("decode_complex_fused_prepacked", (Mcd, Kcd, Ncd), us_cd,
                 us_cr / us_cd, "skinny fused complex CUDA kernel vs its "
                 "4-pass plain version at decode shape (bit-identical)"
                 + ("" if ok_cd else "; MISMATCH"))
    else:
        B.record("decode_complex_fused_prepacked", (Mcd, Kcd, Ncd), None,
                 None, "parity only: skinny fused complex plain version vs "
                 "4-pass reference: "
                 + ("bit-identical" if ok_cd else "MISMATCH"))
    assert ok_cd, "skinny fused complex kernel diverged from the reference"

    # ---- integer oracle and the all-digital W8A8 baseline ----------------
    qx = rand_q(k1, M, K).to(torch.int8)
    qw = rand_q(k2, K, N).to(torch.int8)
    us_ref, _ = B.time_us(lambda: ccim_matmul_ref(qx, qw), 3, 2)
    B.record("ccim_ref_oracle", (M, K, N), us_ref,
             note="int GEMM (plain oracle)")
    us_i8, _ = B.time_us(lambda: int8_matmul(x, w), 3, 2)
    B.record("int8_w8a8", (M, K, N), us_i8,
             note="all-digital CIM baseline [11] numerics"
             + (" (W8A8 CUDA kernel)" if on_card else ""))
    if scale == "card":
        for m in INT8_MS:
            for name, (k, n) in MINICPM_LAYER.items():
                km = prng.split(prng.fold_in(key, m))
                xm, wm = prng.normal(km[0], (m, k)), prng.normal(km[1],
                                                                 (k, n))
                us_k, y_k = B.time_us(lambda: int8_matmul(xm, wm), 20, 3)
                us_p, y_p = B.time_us(lambda: int8_matmul(
                    xm, wm, use_kernel=False), 5, 1)
                assert torch.equal(y_k, y_p), \
                    f"W8A8 kernel != plain at minicpm-2b {name} M={m}"
                B.record("int8_w8a8", (m, k, n), us_k, us_p / us_k,
                         f"minicpm-2b {name}: W8A8 with dynamic quantization"
                         + (" (CUDA kernel)" if on_card else "")
                         + " vs its plain version (bit-identical)")
    return B.records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device ('cpu' for the plain "
                         "versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", choices=sorted(DECODE_SHAPE), default="ref")
    ap.add_argument("--quick", action="store_true",
                    help="time the broadcast and bit-true rows once")
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    header = dict(bench="kernels", device=(torch.cuda.get_device_name(dev)
                                           if dev.type == "cuda" else "cpu"),
                  scale=args.scale, seed=args.seed, torch=torch.__version__)
    print(json.dumps(header), flush=True)
    rows = run(args.seed, dev, args.scale, args.quick)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(header, records=rows), f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
