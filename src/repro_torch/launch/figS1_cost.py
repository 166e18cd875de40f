"""Fig. S1: area, latency and power against the duplicated-weight and
sequential complex-CIM baselines, and their functional equivalence.

Twin of ``benchmarks/figS1_cost.py``: the cost rows come from
``core/costmodel.py`` (plain Python, float64); the equivalence row runs
the three dataflows on the reference's operands and dies
(``split(PRNGKey(seed), 6)``: four ``randint`` operands of (4, 16), two
keyed dies) through the bit-true model on ``device``.

    PYTHONPATH=src python -m repro_torch.launch.figS1_cost --device cpu
    PYTHONPATH=src python -m repro_torch.launch.figS1_cost      # the card
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import resolve_device
from ..core import baselines, prng
from ..core.ccim import DEFAULT_CONFIG, fabricate
from ..core.costmodel import (density_mb_per_mm2, figS1_comparison,
                              macro_area_breakdown)
from .figrows import Rows, printer


def run(seed: int = 0, device=None, emit=printer) -> dict:
    """Every row of the figure; returns {name: row}."""
    dev = resolve_device(device)
    cfg = DEFAULT_CONFIG
    rows = Rows(emit)
    cmp = figS1_comparison(cfg)
    for k in ("this_work", "duplicated", "sequential"):
        c = cmp[k]
        rows.add(f"figS1.{k}", 0.0,
                 f"area {c['area_mm2']*1e3:.1f}e-3mm2 | latency "
                 f"{c['latency_cycles_per_cmac']:.2f} conv/CMAC | power "
                 f"{c['power_rel']:.2f}x", **c)
    s = cmp["savings"]
    rows.add("figS1.savings", 0.0,
             f"area -{s['area_pct_vs_duplicated']:.0f}% (paper -35%), "
             f"latency -{s['latency_pct_vs_sequential']:.0f}% (paper -54%), "
             f"power -{s['power_pct_vs_duplicated']:.0f}% (paper -24%)",
             **{k: v for k, v in s.items() if k != "paper"})
    rows.add("figS1.density", 0.0,
             f"{density_mb_per_mm2():.2f} Mb/mm2 (paper: 1.80, 2x prior 6T "
             "[12-13])", value=density_mb_per_mm2())
    a = macro_area_breakdown(cfg)
    rows.add("figS1.area_breakdown", 0.0,
             f"sram {a['sram']*1e3:.1f} + caps_extra "
             f"{a['caps_extra']*1e3:.1f} + dcim {a['dcim']*1e3:.2f} + adc "
             f"{a['adc']*1e3:.2f} + ctrl {a['ctrl']*1e3:.2f} e-3mm2 (caps "
             "live on M7 above the array)", **a)

    # the three dataflows compute the same function (one weight residency
    # here and in the sequential design, two dies in the duplicated one)
    ks = prng.split(prng.PRNGKey(seed, dev), 6)
    q = lambda k: prng.randint(k, (4, cfg.acc_len), -127, 128).clamp(-127,
                                                                     127)
    xr, xi, wr, wi = q(ks[0]), q(ks[1]), q(ks[2]), q(ks[3])
    m1, m2 = fabricate(ks[4], cfg), fabricate(ks[5], cfg)
    d_re, _ = baselines.duplicated_cmac(xr, xi, wr, wi, m1, m2, cfg)
    s_re, _ = baselines.sequential_cmac(xr, xi, wr, wi, m1, cfg)
    host = lambda t: t.cpu().numpy().astype(np.int64)
    exact_re = (host(xr) * host(wr) - host(xi) * host(wi)).sum(-1)
    err_d = int(np.abs(host(d_re) * cfg.dcim_lsb - exact_re).max())
    err_s = int(np.abs(host(s_re) * cfg.dcim_lsb - exact_re).max())
    rows.add("figS1.functional_equivalence", 0.0,
             f"max |err| duplicated {err_d:.0f} vs sequential {err_s:.0f} "
             f"(both <= few ADC LSB = {cfg.dcim_lsb})",
             err_duplicated=err_d, err_sequential=err_s,
             d_re=host(d_re).tolist(), s_re=host(s_re).tolist())
    return rows.rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device ('cpu' for the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.seed, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
