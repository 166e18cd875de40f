"""Fig. 2: bit-product contribution analysis and the 2-D array's
optimization.

Twin of ``benchmarks/fig2_contribution.py``: the top-3 bit products
carry about half the output contribution (so they go to the DCIM
group), and the DCIM split with the split-DAC shrinks the analog array.
Plain Python and numpy (float64), no device work; prints the
reference's rows.

    PYTHONPATH=src python -m repro_torch.launch.fig2_contribution
"""
from __future__ import annotations

import numpy as np

from ..core.ccim import DEFAULT_CONFIG, contribution_table
from ..core.costmodel import _array_caps
from .figrows import Rows, printer


def run(emit=printer) -> dict:
    """Every row of the figure; returns {name: row}."""
    cfg = DEFAULT_CONFIG
    rows = Rows(emit)
    flat = np.sort(contribution_table(cfg).flatten())[::-1]
    top3 = flat[:3].sum()
    rows.add("fig2.top3_contribution_pct", 0.0,
             f"{100*top3:.1f}% (paper: ~50% -> DCIM group)",
             value=float(100 * top3))
    for k in (1, 3, 6, 10):
        cum = 100 * flat[:k].sum()
        rows.add(f"fig2.topk_cum_pct.k{k}", 0.0, f"{cum:.1f}%",
                 value=float(cum))
    naive_caps = sum(2.0 ** (j + k) for j in range(7) for k in range(7))
    opt_caps = _array_caps(cfg)
    rows.add("fig2.array_caps_naive", 0.0, f"{naive_caps:.0f} unit caps",
             value=naive_caps)
    rows.add("fig2.array_caps_optimized", 0.0,
             f"{opt_caps:.0f} unit caps ({naive_caps/opt_caps:.1f}x "
             "reduction via DCIM-split + split-DAC)", value=float(opt_caps))
    adc_req = int(np.ceil(np.log2(16 * (127 * 127 - 8192) / 2048 + 1)))
    rows.add("fig2.required_adc_bits", 0.0,
             f"{adc_req + 1}b incl sign (paper: 7b)", value=adc_req + 1)
    return rows.rows


def main() -> int:
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
