"""Candidate macro design points a deployment planner sweeps.

Counterpart of ``repro/plan/candidates.py``.  One ``Candidate`` is a
``PlanEntry`` plus its modeled per-MAC cost from
``core.costmodel.macro_cost``.  The default sweep walks the knobs the
paper exposes: ``n_dcim_products`` 6..0 (the D/A boundary), ``adc_bits``
sized per split by ``min_adc_bits`` (the prototype's top-3 / 7 b point
kept verbatim), ``acc_len`` 16 and 32, and the all-digital ``exact``
fidelity.  ``combined_cost`` folds energy, area and latency into one
scalar, each normalized to the all-digital design.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.ccim import CCIMConfig, DEFAULT_CONFIG
from ..core.costmodel import MacroCost, macro_cost
from .plan import PlanEntry

# (energy, area, latency) weights of the combined modeled-cost scalar.
DEFAULT_COST_WEIGHTS = (0.5, 0.3, 0.2)


def min_adc_bits(cfg: CCIMConfig) -> int:
    """Smallest SAR resolution that never clips a full accumulate.

    Exhaustive over the magnitude-product table: the worst-case analog
    sum is ``acc_len * max(|I||W| - dcim_lsb * dcim(|I|,|W|))``, and the
    bipolar ADC must cover it at LSB ``dcim_lsb``.  Gives the prototype's
    7 bits for the top-3 split.
    """
    m = np.arange(cfg.max_mag + 1)
    prod = m[:, None] * m[None, :]
    d = np.zeros_like(prod)
    for j, k in cfg.dcim_products:
        d = d + ((m[:, None] >> j) & 1) * ((m[None, :] >> k) & 1) * (
            (1 << (j + k)) // cfg.dcim_lsb)
    acim_max = int(cfg.acc_len * (prod - d * cfg.dcim_lsb).max())
    if acim_max <= 0:
        return 1
    return max(1, math.ceil(math.log2(acim_max / cfg.dcim_lsb)) + 1)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One sweepable design point with its modeled per-MAC cost."""

    entry: PlanEntry
    cost: MacroCost

    @property
    def label(self) -> str:
        return self.entry.label


def make_candidate(label: str, cfg: CCIMConfig = DEFAULT_CONFIG,
                   fidelity: str = "fast") -> Candidate:
    entry = PlanEntry(cfg=cfg, fidelity=fidelity, label=label)
    return Candidate(entry=entry, cost=macro_cost(cfg, fidelity))


def combined_cost(c: Candidate, digital: Candidate,
                  weights: Tuple[float, float, float] = DEFAULT_COST_WEIGHTS
                  ) -> float:
    """Scalar modeled cost per MAC, normalized so all-digital == 1.0."""
    we, wa, wl = weights
    return (we * c.cost.energy_pj_per_mac / digital.cost.energy_pj_per_mac
            + wa * c.cost.area_mm2_per_kb / digital.cost.area_mm2_per_kb
            + wl * c.cost.latency_cyc_per_mac
            / digital.cost.latency_cyc_per_mac)


def default_candidates(base: CCIMConfig = DEFAULT_CONFIG,
                       n_dcim_sweep: Sequence[int] = (6, 5, 4, 3, 2, 1, 0),
                       acc_len_sweep: Sequence[int] = (16, 32),
                       include_digital: bool = True) -> List[Candidate]:
    """The default design space, most accurate first.  Every ``fast``
    point lies inside the prepacked kernels' envelope (7 magnitude bits,
    at most 6 planes, acc_len 16 or 32), so on the card each one serves
    through kernel rows 1 and 2."""
    cands: List[Candidate] = []
    if include_digital:
        cands.append(make_candidate("digital", base, fidelity="exact"))
    for acc_len in acc_len_sweep:
        for k in n_dcim_sweep:
            cfg = dataclasses.replace(base, n_dcim_products=k, acc_len=acc_len)
            adc = min_adc_bits(cfg)
            if k == base.n_dcim_products and acc_len == base.acc_len:
                adc = base.adc_bits          # the taped-out prototype point
            cfg = dataclasses.replace(cfg, adc_bits=adc)
            name = "hybrid" if k else "analog"
            cands.append(make_candidate(
                f"{name}{k}/adc{adc}/L{acc_len}", cfg))
    return cands


def candidates_by_label(cands: Sequence[Candidate]) -> Dict[str, Candidate]:
    return {c.label: c for c in cands}


def prototype_candidate(base: CCIMConfig = DEFAULT_CONFIG) -> Candidate:
    """The paper's 28 nm operating point (top-3 split, 7 b SAR, L 16)."""
    return make_candidate(
        f"hybrid{base.n_dcim_products}/adc{base.adc_bits}/L{base.acc_len}",
        base)


def digital_candidate(base: CCIMConfig = DEFAULT_CONFIG) -> Candidate:
    return make_candidate("digital", base, fidelity="exact")
