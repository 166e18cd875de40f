"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM's schedule).

Counterpart of ``repro/optim/schedules.py``.  A schedule is a scalar
function of the step, so it is evaluated on the host in float32, as the
reference's jitted step computes it on the CPU: XLA folds ``peak_lr /
warmup`` into one constant (the reciprocal of the divisor times the
numerator), multiplies by reciprocals of constant divisors, fuses the
cosine's final multiply-add, takes the C library's ``cosf``, folds
``log(final_frac)`` correctly rounded and evaluates exp with its own
float32 code (``prng.exp``).  The values equal the jitted reference's
at every step (``tests/test_torch_train.py``).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

from ..core import prng

_f32 = np.float32


@functools.lru_cache(maxsize=1)
def _cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def _recip(d) -> np.float32:
    return _f32(_f32(1.0) / _f32(d))


def _warm(step: np.float32, peak_lr: float, warmup: int) -> np.float32:
    return _f32(_f32(_f32(peak_lr) * _recip(max(warmup, 1))) * step)


def _clip01(v) -> np.float32:
    return _f32(min(max(_f32(v), _f32(0.0)), _f32(1.0)))


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> float:
    s = _f32(step)
    if s < warmup:
        return float(_warm(s, peak_lr, warmup))
    prog = _clip01(_f32(s - _f32(warmup)) * _recip(max(total - warmup, 1)))
    c = _f32(_cosf()(float(_f32(_f32(np.pi) * prog))))
    # final_frac + (1 - final_frac) * 0.5 * (1 + cos): one fused multiply-add
    cos = _f32(np.float64(_f32((1 - final_frac) * 0.5))
               * np.float64(_f32(_f32(1.0) + c)) + np.float64(_f32(final_frac)))
    return float(_f32(_f32(peak_lr) * cos))


def wsd(step, *, peak_lr: float, warmup: int, total: int,
        decay_frac: float = 0.1, final_frac: float = 0.01) -> float:
    """Warmup -> Stable (constant) -> Decay (the last ``decay_frac`` of
    training, an exponential anneal to ``final_frac`` of the peak)."""
    s = _f32(step)
    decay_steps = max(_f32(total * decay_frac), _f32(1.0))
    decay_start = _f32(_f32(total) - decay_steps)
    if s > decay_start:
        prog = _clip01(_f32(s - decay_start) * _recip(decay_steps))
        arg = torch.tensor(_f32(np.log(_f32(final_frac))) * prog)
        return float(_f32(_f32(peak_lr) * _f32(prng.exp(arg).item())))
    if s < warmup:
        return float(_warm(s, peak_lr, warmup))
    return float(_f32(peak_lr))


def make_schedule(name: str, **kw):
    if name == "cosine":
        return lambda s: warmup_cosine(s, **kw)
    if name == "wsd":
        return lambda s: wsd(s, **kw)
    raise ValueError(name)
