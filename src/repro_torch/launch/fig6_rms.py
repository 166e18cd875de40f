"""Fig. 6: C-MAC RMS error under uniform inputs (no sparsity), and energy.

Twin of ``benchmarks/fig6_rms.py``.  Paper: 0.435 % rms (measured on
silicon, dynamic noise included), 35.0 TOPS/W.  Uniform random
16-element SMF conversions go through the bit-true macro model; each
row prints one JSON line:

  * this work: the bit-true model on a fabricated macro (cap and CDAC
    mismatch, VREF polarity, rounding) with the SAR's comparator noise;
  * this die without the dynamic noise (an extra row; the reference's
    model notes put mismatch + rounding at 0.29 %);
  * the ADC-rounding floor (``hybrid_mac_ideal``: no mismatch);
  * all-analog CIM [4-5] on its own die (``all_analog_config``),
    noise-free as the reference runs it;
  * all-digital CIM [11], exact;
  * the energy breakdown and TOPS/W of the cost model.

Inputs, dies and the noise key are the reference's draws
(``core/prng.py``): ``split(PRNGKey(seed), 4)``, the operands
``randint`` under keys 0 and 1, this die under key 2, the all-analog
die and the comparator noise under key 3.  The draws are partitionable,
so the card's 2^20 conversions hold the reference's 16,384 as their
first rows, codes and all.

    PYTHONPATH=src python -m repro_torch.launch.fig6_rms      # card, n 2^20
    PYTHONPATH=src python -m repro_torch.launch.fig6_rms --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import baselines, prng
from ..core.ccim import (CCIMConfig, DEFAULT_CONFIG, MacroInstance, fabricate,
                         hybrid_mac_bit_true, hybrid_mac_ideal)
from ..core.costmodel import energy_per_conversion_pj, tops_per_watt

REF_N = 16384              # the reference's conversion count
CARD_N = 1 << 20           # 64x the reference's, on the card
# conversions per evaluation chunk, by device type: on the card one chunk
# of 2^20 peaks under 2 GB; on the host 2^18 bounds the working set
CHUNK = {"cuda": 1 << 20, "cpu": 1 << 18}


def default_n(dev: torch.device) -> int:
    """The conversion count of a run on ``dev``."""
    return CARD_N if dev.type == "cuda" else REF_N


def rms_pct(y8: torch.Tensor, exact: torch.Tensor, cfg: CCIMConfig) -> float:
    """RMS error in % of the full-scale output range, in float64 on the
    host as the reference computes it (numpy's pairwise mean)."""
    err = (y8.cpu().numpy().astype(np.int64) * cfg.dcim_lsb
           - exact.cpu().numpy()).astype(np.float64)
    fs = 2 * 64 * cfg.dcim_lsb
    return float(100 * np.sqrt(np.mean((err / fs) ** 2)))


def conversions(seed: int, n: int, cfg: CCIMConfig = DEFAULT_CONFIG,
                device="cpu"):
    """(x_q, w_q, macro, macro_analog, noise_key): n uniform SMF
    conversions, the two dies and the comparator-noise key, drawn on
    ``device`` from ``PRNGKey(seed)`` as the reference draws them."""
    ks = prng.split(prng.PRNGKey(seed, device), 4)
    draw = lambda k: prng.randint(k, (n, cfg.acc_len), -127, 128).clamp(
        -127, 127)
    return (draw(ks[0]), draw(ks[1]), fabricate(ks[2], cfg),
            fabricate(ks[3], baselines.all_analog_config(cfg)), ks[3])


def evaluate(xq: torch.Tensor, wq: torch.Tensor, macro: MacroInstance,
             macro_a: MacroInstance, noise_key: torch.Tensor,
             cfg: CCIMConfig = DEFAULT_CONFIG) -> Dict[str, torch.Tensor]:
    """y8 of every conversion under this work (the die with the
    comparator noise of ``noise_key``), this die without it, the floor
    and the all-analog die, and the exact dot; int32, on xq's device,
    ``CHUNK`` of that device conversions at a time (each chunk draws its
    own conversions' noise)."""
    cfg_a = baselines.all_analog_config(cfg)
    chunk = CHUNK[xq.device.type]
    parts: Dict[str, list] = {"this_work": [], "floor": [], "this_die": [],
                              "all_analog": [], "exact": []}
    for i in range(0, xq.shape[0], chunk):
        x, w = xq[i:i + chunk], wq[i:i + chunk]
        parts["this_work"].append(hybrid_mac_bit_true(
            x, w, macro, cfg, noise_key, draw_offset=i)["y8"])
        out = hybrid_mac_bit_true(x, w, macro, cfg)
        parts["this_die"].append(out["y8"])
        parts["exact"].append(out["exact"])
        parts["floor"].append(hybrid_mac_ideal(x, w, cfg))
        parts["all_analog"].append(
            hybrid_mac_bit_true(x, w, macro_a, cfg_a)["y8"])
    return {k: torch.cat(v) for k, v in parts.items()}


def rows(ys: Dict[str, torch.Tensor], cfg: CCIMConfig = DEFAULT_CONFIG
         ) -> Dict[str, float]:
    """The RMS rows (%) of ``evaluate``'s outputs."""
    return {"this_work": rms_pct(ys["this_work"], ys["exact"], cfg),
            "floor": rms_pct(ys["floor"], ys["exact"], cfg),
            "this_die": rms_pct(ys["this_die"], ys["exact"], cfg),
            "all_analog": rms_pct(ys["all_analog"], ys["exact"],
                                  baselines.all_analog_config(cfg))}


def run(seed: int = 0, n: Optional[int] = None, device=None,
        emit: Callable[[dict], None] = lambda row: print(json.dumps(row),
                                                         flush=True)
        ) -> dict:
    """Every row of the figure over ``n`` conversions (default CARD_N on
    the card, REF_N on the CPU); returns {"rms": ..., "ys": ..., "us":
    ..., "n": ...} with ``us`` the time of ``evaluate`` on the device
    (CUDA events on the card, host clock on the CPU)."""
    dev = resolve_device(device)
    n = n or default_n(dev)
    cfg = DEFAULT_CONFIG
    xq, wq, macro, macro_a, key = conversions(seed, n, cfg, dev)
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ys = evaluate(xq, wq, macro, macro_a, key, cfg)
        b.record()
        b.synchronize()
        us = 1e3 * a.elapsed_time(b)
    else:
        t0 = time.perf_counter()
        ys = evaluate(xq, wq, macro, macro_a, key, cfg)
        us = 1e6 * (time.perf_counter() - t0)
    r = rows(ys, cfg)
    emit(dict(name="fig6.rms_this_work_pct", value=r["this_work"], n=n,
              us=us, note="bit-true, fabricated die, comparator noise 0.45 "
              "LSB (paper measured: 0.435%; mismatch + rounding 0.29% + "
              "dynamic noise); us: every row of evaluate together"))
    emit(dict(name="fig6.rms_this_die_noise_free_pct", value=r["this_die"],
              n=n, note="the same die without the dynamic noise (mismatch + "
              "rounding; the reference's model notes: 0.29%)"))
    emit(dict(name="fig6.rms_quantization_floor_pct", value=r["floor"], n=n,
              note="ADC rounding only"))
    emit(dict(name="fig6.rms_all_analog_pct", value=r["all_analog"], n=n,
              note="conventional ACIM [4-5] on its own die, noise-free: MSB "
                   "mismatch dominates"))
    emit(dict(name="fig6.rms_all_digital_pct", value=0.0, n=n,
              note="exact [11]; costs area/power, see figS1"))
    e = energy_per_conversion_pj(cfg)
    emit(dict(name="fig6.energy_breakdown_pj", value=e["total"],
              parts={k: e[k] for k in ("array", "adc", "dcim", "comparator",
                                       "drivers")},
              note="pJ per conversion; the ACIM side dominates, as measured"))
    emit(dict(name="fig6.tops_per_watt", value=tops_per_watt(cfg),
              note="derived (paper measured: 35.0)"))
    return {"rms": r, "ys": ys, "us": us, "n": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device ('cpu' for the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = default_n(dev)
    print(json.dumps(dict(bench="fig6", device=(
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        seed=args.seed, n=n)), flush=True)
    run(args.seed, n, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
