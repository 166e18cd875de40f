"""Measure the float32 sum order of the reference profiler's ``rel_rms``
(``jnp.linalg.norm`` run eagerly: ``sum(x * x)`` over every axis of the
float32 logits) against candidate rules the port could reproduce.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/rms_order_probe.py \
        [--trials 10]

For each shape (the planner test's calibration logits (1, 8, 512), the
(2, 16, 512) default batch, a few others), it draws ``--trials`` seeded
float32 arrays, takes XLA-CPU's eager sum of squares, and counts the
trials on which each rule's float32 sum is ``==``:

  win1d   flatten, then XLA's 32-wide windowed order
          (``layers._window_sum``, the rule of a one-axis reduction);
  seq     flatten, then one running float32 sum in row-major order;
  lastwin the last axis windowed (32), repeated while any axis is longer
          than 32, then the rest as win1d;
  allwin  every axis longer than 32 windowed at once, last axis first,
          repeated, then a row-major running sum.

Prints one line per shape.  A rule is the reference's only where it
holds on every trial of every shape; exits 0 if one does, 1 otherwise
(then the port keeps its float64 sum and the test its rtol).
"""
from __future__ import annotations

import argparse
import sys

import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.models.layers import _window_sum

W = 32
SHAPES = ((1, 8, 512), (2, 16, 512), (1, 1, 512), (4096,), (3, 5, 7),
          (40, 40), (8, 512), (2, 80, 512))


def _seq(a, axis=-1):
    return np.cumsum(a, axis=axis, dtype=np.float32).take(-1, axis=axis)


def _win_axis(a, d):
    n = a.shape[d]
    pad = -n % W
    width = [(0, 0)] * a.ndim
    width[d] = (pad // 2, pad - pad // 2)
    a = np.moveaxis(np.pad(a, width), d, -1)
    return np.moveaxis(_seq(a.reshape(a.shape[:-1] + (-1, W))), -1, d)


def win1d(a):
    return np.float32(_window_sum(torch.from_numpy(a.reshape(-1))).item())


def seq(a):
    return _seq(a.reshape(-1))


def lastwin(a):
    while a.shape[-1] > W:
        a = _win_axis(a, a.ndim - 1)
    return win1d(np.ascontiguousarray(a))


def allwin(a):
    while any(n > W for n in a.shape):
        for d in reversed(range(a.ndim)):
            if a.shape[d] > W:
                a = _win_axis(a, d)
    return _seq(a.reshape(-1))


RULES = dict(win1d=win1d, seq=seq, lastwin=lastwin, allwin=allwin)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=10)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    whole = dict.fromkeys(RULES, True)
    for shape in SHAPES:
        hits = dict.fromkeys(RULES, 0)
        for _ in range(args.trials):
            x = (rng.standard_normal(shape)
                 * rng.uniform(0.1, 10)).astype(np.float32)
            j = jnp.asarray(x)
            want = np.float32(jnp.sum(jnp.real(j * jnp.conj(j))))
            for name, rule in RULES.items():
                hits[name] += int(rule(x * x) == want)
        for name in RULES:
            whole[name] &= hits[name] == args.trials
        print(shape, " ".join(f"{n} {h}/{args.trials}"
                              for n, h in hits.items()))
    held = [n for n, ok in whole.items() if ok]
    print("rules that hold on every shape:", held or "none")
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
