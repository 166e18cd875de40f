"""Fig. S2: Monte-Carlo RMS error against capacitor mismatch.

Twin of ``benchmarks/figS2_montecarlo.py``: sigma_unit at 0.5x, 1x, 2x
and 4x the designed 2.96 %, each over ``n_dies`` keyed dies
(``fabricate(PRNGKey(seed + i))``), 2,048 uniform conversions a die
(``randint`` under ``split(PRNGKey(seed + 999))``, the same operands for
every die) through the bit-true model, noise-free as the reference runs
it.  One die's RMS cannot rank the hybrid against all-analog (Fig. 6);
the spread over dies can, so the twin adds a row per multiplier that
runs the same die keys and operands under all-analog CIM
(``baselines.all_analog_config``: no DCIM group, an 8-bit ADC).  Each
row carries the per-die RMS values.

    PYTHONPATH=src python -m repro_torch.launch.figS2_montecarlo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.figS2_montecarlo  # the card
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..core import baselines, prng
from ..core.ccim import (CCIMConfig, DEFAULT_CONFIG, fabricate,
                         hybrid_mac_bit_true)
from .fig6_rms import rms_pct
from .figrows import Rows, printer

MULTS = (0.5, 1.0, 2.0, 4.0)


def operands(data_key: torch.Tensor, n: int, cfg: CCIMConfig):
    """(x_q, w_q), (n, acc_len) each, as the reference draws them."""
    k1, k2 = prng.split(data_key)
    draw = lambda k: prng.randint(k, (n, cfg.acc_len), -127, 128).clamp(
        -127, 127)
    return draw(k1), draw(k2)


def die_rms(cfg: CCIMConfig, die_key: torch.Tensor, xq: torch.Tensor,
            wq: torch.Tensor) -> float:
    """RMS error (% of full scale) of one keyed die on the conversions."""
    out = hybrid_mac_bit_true(xq, wq, fabricate(die_key, cfg), cfg)
    return rms_pct(out["y8"], out["exact"], cfg)


def run(seed: int = 0, n_dies: int = 8, n: int = 2048, device=None,
        emit=printer) -> dict:
    """Every row of the figure; returns {name: row}, each sweep row with
    its per-die RMS values under "dies"."""
    dev = resolve_device(device)
    rows = Rows(emit)
    xq, wq = operands(prng.PRNGKey(seed + 999, dev), n, DEFAULT_CONFIG)
    for mult in MULTS:
        cfg = dataclasses.replace(DEFAULT_CONFIG, sigma_unit=0.0296 * mult)
        dies: List[float] = [die_rms(cfg, prng.PRNGKey(seed + i, dev), xq,
                                     wq) for i in range(n_dies)]
        rows.add(f"figS2.mc_rms_at_{mult:.1f}x_mismatch", 0.0,
                 f"sigma_u={100*cfg.sigma_unit:.2f}%: "
                 f"{np.mean(dies):.3f}% rms (die-to-die std "
                 f"{np.std(dies):.3f}) over {n_dies} dies",
                 dies=dies, mean=float(np.mean(dies)),
                 std=float(np.std(dies)))
    for mult in MULTS:
        cfg = baselines.all_analog_config(dataclasses.replace(
            DEFAULT_CONFIG, sigma_unit=0.0296 * mult))
        dies = [die_rms(cfg, prng.PRNGKey(seed + i, dev), xq, wq)
                for i in range(n_dies)]
        rows.add(f"figS2.mc_rms_all_analog_at_{mult:.1f}x_mismatch", 0.0,
                 f"all-analog [4-5], sigma_u={100*cfg.sigma_unit:.2f}%: "
                 f"{np.mean(dies):.3f}% rms (die-to-die std "
                 f"{np.std(dies):.3f}) over the same {n_dies} die keys",
                 dies=dies, mean=float(np.mean(dies)),
                 std=float(np.std(dies)))
    rows.add("figS2.conclusion", 0.0,
             "flat through the 2.96% design point -> viable (paper Fig. S2)")
    return rows.rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device ('cpu' for the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dies", type=int, default=8)
    args = ap.parse_args(argv)
    run(args.seed, args.dies, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
