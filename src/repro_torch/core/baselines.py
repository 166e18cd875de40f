"""Functional accuracy baselines the paper compares against (Fig. 6).

Counterpart of ``repro/core/baselines.py``; a noise key adds the SAR's
comparator noise as the reference draws it (the complex baselines split
it in four, one key per sub-MAC in the order ac, bd, ad, bc):

  * duplicated-weight C-CIM [3]  -- two independent macro instances (two
    mismatch draws), weights quantized twice; 1.5x area.
  * sequential C-CIM             -- same macro reused over 4 passes (fully
    correlated mismatch), 2.2x latency.
  * all-analog CIM [4-5]         -- every bit-product through the cap array
    + a wider ADC; MSB caps carry the dominant mismatch -> worse RMS.
  * all-digital CIM [11]         -- exact (only quantization of operands),
    the accuracy ceiling; costed in costmodel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import ccim, prng
from .ccim import CCIMConfig, DEFAULT_CONFIG, MacroInstance


def all_digital_mac(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact integer MAC over the last axis (all-digital CIM [11]), int32."""
    return (x_q.to(torch.int32) * w_q.to(torch.int32)).sum(-1)


def all_analog_config(cfg: CCIMConfig = DEFAULT_CONFIG) -> CCIMConfig:
    """All bit-products in analog; the ADC must cover the full product
    range: sum(|I||W|) = 16 * 127^2 < 2^18, so with LSB 2^11 it needs 8
    bits."""
    return dataclasses.replace(cfg, n_dcim_products=0, adc_bits=8)


def all_analog_mac(x_q: torch.Tensor, w_q: torch.Tensor,
                   macro: MacroInstance, cfg: Optional[CCIMConfig] = None,
                   noise_key=None) -> dict:
    cfg = all_analog_config(cfg or DEFAULT_CONFIG)
    return ccim.hybrid_mac_bit_true(x_q, w_q, macro, cfg, noise_key)


def _four_sub_macs(x_re, x_im, w_re, w_im, macro_ac_bd, macro_ad_bc, cfg,
                   noise_key) -> Tuple[torch.Tensor, torch.Tensor]:
    keys = ((None,) * 4 if noise_key is None
            else prng.split(noise_key, 4).unbind(-2))
    y8 = lambda x, w, m, k: ccim.hybrid_mac_bit_true(x, w, m, cfg, k)["y8"]
    ac = y8(x_re, w_re, macro_ac_bd, keys[0])
    bd = y8(x_im, w_im, macro_ac_bd, keys[1])
    ad = y8(x_re, w_im, macro_ad_bc, keys[2])
    bc = y8(x_im, w_re, macro_ad_bc, keys[3])
    return ac - bd, ad + bc


def duplicated_cmac(x_re, x_im, w_re, w_im, macro_a: MacroInstance,
                    macro_b: MacroInstance, cfg: CCIMConfig = DEFAULT_CONFIG,
                    noise_key=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline (a): Re lane on die-copy A, Im lane on die-copy B."""
    return _four_sub_macs(x_re, x_im, w_re, w_im, macro_a, macro_b, cfg,
                          noise_key)


def sequential_cmac(x_re, x_im, w_re, w_im, macro: MacroInstance,
                    cfg: CCIMConfig = DEFAULT_CONFIG, noise_key=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline (b): all four sub-MACs sequenced on ONE macro."""
    return _four_sub_macs(x_re, x_im, w_re, w_im, macro, macro, cfg,
                          noise_key)
