"""Fig. 5: the measured transfer function and INL.

Twin of ``benchmarks/fig5_transfer.py``: the input sweeps -FS..+FS (255
points, a uniform 16-element vector each) with every weight at -127, as
the paper measures it, through the bit-true model on the reference's die
(``fabricate(PRNGKey(seed))``); the rows give the sweep's time, the gain
error of a least-squares line, the largest INL and the INL at the zero
crossing.  The sweep's time is CUDA events around one call on the card
(the mean of 5 after 2 warm-ups, as the reference times it), the host
clock on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.fig5_transfer --device cpu
    PYTHONPATH=src python -m repro_torch.launch.fig5_transfer    # the card
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..core import prng
from ..core.ccim import DEFAULT_CONFIG, fabricate, hybrid_mac_bit_true
from .figrows import Rows, printer


def time_us(fn, dev: torch.device, iters: int = 5, warmup: int = 2
            ) -> float:
    """Mean microseconds of ``fn()`` (CUDA events on the card)."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return 1e3 * a.elapsed_time(b) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e6 * (time.perf_counter() - t0) / iters


def run(seed: int = 0, device=None, emit=printer) -> dict:
    """Every row of the figure; returns {name: row} (the sweep's codes
    under "fig5.transfer_sweep")."""
    dev = resolve_device(device)
    cfg = DEFAULT_CONFIG
    rows = Rows(emit)
    macro = fabricate(prng.PRNGKey(seed, dev), cfg)
    sweep = torch.arange(-127, 128, device=dev, dtype=torch.int32)
    x = sweep[:, None].expand(255, cfg.acc_len)      # a uniform vector
    w = torch.full((255, cfg.acc_len), -127, dtype=torch.int32, device=dev)
    fn = lambda: hybrid_mac_bit_true(x, w, macro, cfg)["y8"]
    us = time_us(fn, dev)
    y = fn().cpu().numpy().astype(np.float64)

    ideal = np.arange(-127, 128) * (-127.0) * cfg.acc_len / cfg.dcim_lsb
    g = float(np.dot(y, ideal) / np.dot(ideal, ideal))
    inl = y - g * ideal
    lsb = 1.0                    # one output LSB (2^11 at product scale)
    rows.add("fig5.transfer_sweep", us,
             "255-point sweep, W=-127 (paper protocol)",
             y8=y.astype(np.int64).tolist())
    rows.add("fig5.gain_error_pct", 0.0, f"{100*abs(1-g):.2f}% (paper: ~0)",
             value=100 * abs(1 - g))
    at = int(np.abs(inl).argmax()) - 127
    rows.add("fig5.max_inl_lsb", 0.0,
             f"{np.abs(inl).max()/lsb:.2f} LSB at code {at} "
             "(paper: max INL at zero crossing)",
             value=float(np.abs(inl).max() / lsb), at_code=at)
    zc = np.abs(inl[126:129]).max() / lsb
    rows.add("fig5.inl_at_zero_crossing_lsb", 0.0, f"{zc:.2f} LSB",
             value=float(zc))
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
