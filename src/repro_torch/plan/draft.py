"""Draft plans for plan-cascade speculative decoding.

Counterpart of ``repro/plan/draft.py``.  An all-analog plan drafts k
tokens, the deployed plan verifies all k+1 positions in one wide forward,
and greedy accept-longest-prefix keeps the output exactly the deployed
plan's.  An all-analog entry with the pack's ``n_mag_bits`` and
``acc_len`` serves the same ``PackedCimWeights`` the verify plan packed
(``core.engine.pack_compatible``): no second pack.

Each verify entry maps to its analog shadow: ``float`` stays (the site is
off the macro, so draft == verify there); ``exact`` and ``fast`` become
``n_dcim_products=0`` at the same ``acc_len``, with ``adc_bits`` the
aggressiveness knob -- ``min_adc_bits`` (no clipping) or narrower SARs
that clip large accumulates and are rejected more often.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..core.ccim import DEFAULT_CONFIG
from .candidates import min_adc_bits
from .plan import DeploymentPlan, PlanEntry


def derive_draft_entry(entry: PlanEntry, adc_bits: Optional[int] = None,
                       adc_delta: int = 0) -> PlanEntry:
    """The all-analog shadow of one plan entry (same pack, no planes).

    ``adc_bits`` forces an absolute SAR width; otherwise the width is the
    entry's no-clip ``min_adc_bits`` plus ``adc_delta`` (negative deltas
    draft more aggressively).  Resolved per entry because different
    ``acc_len`` need different no-clip widths."""
    if entry.fidelity == "float":
        return entry
    cfg = dataclasses.replace(entry.cfg, n_dcim_products=0)
    bits = adc_bits if adc_bits is not None else max(
        1, min_adc_bits(cfg) + adc_delta)
    cfg = dataclasses.replace(cfg, adc_bits=bits)
    return PlanEntry(cfg=cfg, fidelity="fast",
                     label=f"draft-analog0/adc{bits}/L{cfg.acc_len}")


def derive_draft_plan(plan: DeploymentPlan, adc_bits: Optional[int] = None,
                      adc_delta: int = 0) -> DeploymentPlan:
    """Entry-wise analog shadow of a deployment plan.  The mapping keeps
    the keys, so path resolution matches the verify plan site for site,
    and members of a fused group that agreed under the verify plan agree
    under the draft plan too."""
    return DeploymentPlan.from_dict(
        {p: derive_draft_entry(e, adc_bits, adc_delta)
         for p, e in plan.entries},
        default=derive_draft_entry(plan.default, adc_bits, adc_delta))


def draft_plan_for_model(model_cfg, adc_bits: Optional[int] = None,
                         adc_delta: int = 0) -> DeploymentPlan:
    """Draft plan for a model config, planned or global-CIM (anything
    with ``cim_plan``, ``cim_cfg`` and ``cim_fidelity``).  A global-CIM
    config derives from a uniform plan over its one entry."""
    plan = getattr(model_cfg, "cim_plan", None)
    if plan is None:
        base = PlanEntry(cfg=getattr(model_cfg, "cim_cfg", None)
                         or DEFAULT_CONFIG,
                         fidelity=getattr(model_cfg, "cim_fidelity", "fast"))
        plan = DeploymentPlan.uniform(base)
    return derive_draft_plan(plan, adc_bits, adc_delta)


def draft_plan_sweep(plan: DeploymentPlan,
                     adc_deltas: Sequence[int] = (0, -1, -2),
                     ) -> List[Tuple[str, DeploymentPlan]]:
    """(label, draft_plan) points of increasing draft aggressiveness:
    delta 0 is the no-clip analog shadow, each further delta narrows
    every entry's SAR by that many bits below its own no-clip width.
    Labels carry the first non-float entry's resulting width."""
    points = []
    for d in adc_deltas:
        dp = derive_draft_plan(plan, adc_delta=d)
        cands = [e for _, e in dp.entries] + [dp.default]
        named = next((e for e in cands if e.fidelity != "float"),
                     derive_draft_entry(PlanEntry(), adc_delta=d))
        points.append((f"analog0/adc{named.cfg.adc_bits}", dp))
    return points
