"""Pareto search: sensitivities + modeled costs -> a DeploymentPlan.

Counterpart of ``repro/plan/search.py``.  Greedy knapsack on modeled
cost saved per unit of accuracy lost:

  1. every site starts on the all-digital candidate;
  2. repeatedly apply the (site, cheaper candidate) move with the best
     ratio (combined cost saved) / (rms^2 added) while the PREDICTED
     total error sqrt(sum_site rms_site^2) stays within the budget;
  3. validate end to end: one forward under the final plan measures the
     output RMS; while it exceeds the budget, the site with the largest
     isolated RMS goes back to digital and the plan is measured again.

The budget defaults to what the prototype design everywhere achieves,
in both spaces (its predicted sqrt-sum-of-squares and its measured RMS),
times ``budget_scale``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..models.config import ModelConfig
from .candidates import (Candidate, DEFAULT_COST_WEIGHTS, candidates_by_label,
                         combined_cost, default_candidates, digital_candidate,
                         prototype_candidate)
from .plan import DeploymentPlan, PlanEntry
from .profiler import (PROFILE_NOISE_SEED, SensitivityProfile,
                       planned_logits, profile_sensitivities,
                       reference_logits, rel_rms)


# ---------------------------------------------------------------------------
# modeled cost of an assignment
# ---------------------------------------------------------------------------


def assignment_cost(assignment: Dict[str, Candidate],
                    profile: SensitivityProfile,
                    weights: Tuple[float, float, float] = DEFAULT_COST_WEIGHTS
                    ) -> Dict[str, float]:
    """Modeled per-token cost of a site -> candidate assignment: energy
    (pJ/token over every planned MAC), area (mm^2 to park the weights at
    each design's density), latency (conversion cycles/token) and
    combined (the MAC-weighted average of each site's digital-normalized
    scalar; 1.0 is all-digital)."""
    dig = digital_candidate()
    energy = area = latency = 0.0
    comb_num = macs_tot = 0.0
    for site, cand in assignment.items():
        macs = profile.macs_per_token(site)
        energy += macs * cand.cost.energy_pj_per_mac
        area += (profile.weights_per_site(site) * 8 / 1024 / 8
                 * cand.cost.area_mm2_per_kb)
        latency += macs * cand.cost.latency_cyc_per_mac
        comb_num += macs * combined_cost(cand, dig, weights)
        macs_tot += macs
    return dict(energy_pj_per_token=energy, area_mm2=area,
                latency_cyc_per_token=latency,
                combined=comb_num / max(macs_tot, 1.0))


def predicted_rms(assignment: Dict[str, Candidate],
                  profile: SensitivityProfile) -> float:
    """sqrt(sum of per-site isolated rms^2), the variance-additive proxy."""
    return math.sqrt(sum(
        profile.rms[s][c.label] ** 2 for s, c in assignment.items()))


def plan_from_assignment(assignment: Dict[str, Candidate],
                         default: Optional[PlanEntry] = None
                         ) -> DeploymentPlan:
    return DeploymentPlan.from_dict(
        {s: c.entry for s, c in assignment.items()},
        default=default or digital_candidate().entry)


# ---------------------------------------------------------------------------
# greedy knapsack + end-to-end validation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanSearchResult:
    plan: DeploymentPlan
    assignment: Dict[str, str]            # site -> candidate label
    profile: SensitivityProfile
    predicted_rms: float
    measured_rms: float                   # end-to-end validation forward
    budget_predicted: float
    budget_measured: float
    cost: Dict[str, float]                # the planned assignment's cost
    cost_digital: Dict[str, float]
    cost_budget_plan: Dict[str, float]    # the uniform budget baseline
    moves: List[Tuple[str, str, float]]   # (site, label, score) applied
    n_reverts: int

    def summary(self) -> Dict:
        return dict(
            assignment=dict(self.assignment),
            predicted_rms=round(self.predicted_rms, 6),
            measured_rms=round(self.measured_rms, 6),
            budget_measured=round(self.budget_measured, 6),
            cost={k: round(v, 6) for k, v in self.cost.items()},
            cost_digital={k: round(v, 6) for k, v in
                          self.cost_digital.items()},
            cost_budget_plan={k: round(v, 6) for k, v in
                              self.cost_budget_plan.items()},
            n_moves=len(self.moves), n_reverts=self.n_reverts,
        )


def _check_labels(candidates: List[Candidate], budget: Candidate
                  ) -> List[Candidate]:
    """The sweep with the digital and budget candidates added; raises on
    label collisions (labels key the profile's columns and the
    assignments)."""
    by_label = candidates_by_label(candidates)
    if len(by_label) != len(candidates):
        seen = set()
        dupes = {c.label for c in candidates
                 if c.label in seen or seen.add(c.label)}
        raise ValueError(f"duplicate candidate labels {sorted(dupes)}")
    dig = digital_candidate()
    if by_label.setdefault(dig.label, dig) != dig:
        raise ValueError(
            f"candidate label {dig.label!r} is reserved for the all-digital "
            "point the greedy search starts from; rename the colliding "
            "candidate")
    if dig.label not in {c.label for c in candidates}:
        candidates = [dig] + candidates
    if by_label.setdefault(budget.label, budget) != budget:
        raise ValueError(
            f"candidate label {budget.label!r} collides with the "
            "budget candidate but describes a different design point")
    if budget.label not in {c.label for c in candidates}:
        candidates = candidates + [budget]
    return candidates


def _restrict(profile: SensitivityProfile, sites: Sequence[str]
              ) -> SensitivityProfile:
    unknown = [s for s in sites if s not in profile.rms]
    if unknown:
        raise ValueError(
            f"sites {unknown} not in the precomputed profile "
            f"(profiled: {sorted(profile.sites)})")
    return SensitivityProfile(
        sites=list(sites),
        site_shapes={s: profile.site_shapes[s] for s in sites},
        labels=list(profile.labels),
        rms={s: dict(profile.rms[s]) for s in sites},
        site_mults={s: profile.site_mults.get(s, 1) for s in sites})


def pareto_search(
    params, cfg: ModelConfig, tokens,
    candidates: Optional[Sequence[Candidate]] = None,
    sites: Optional[Sequence[str]] = None,
    budget_candidate: Optional[Candidate] = None,
    budget_scale: float = 1.0,
    rms_budget: Optional[float] = None,
    cost_weights: Tuple[float, float, float] = DEFAULT_COST_WEIGHTS,
    noise_seed: Optional[int] = PROFILE_NOISE_SEED,
    profile: Optional[SensitivityProfile] = None,
    ref=None,
    validate_tol: float = 1.02,
    verbose: bool = False,
) -> PlanSearchResult:
    """Profile + search + validate: the whole planner in one call.

    ``budget_candidate`` (default: the prototype) defines the accuracy
    budget as what running that design everywhere costs in accuracy;
    ``budget_scale`` tightens it.  ``rms_budget`` targets an absolute
    output RMS instead (it then bounds both predicted and measured
    error).  A precomputed ``profile`` missing the digital or budget
    column gets those columns profiled and merged."""
    candidates = list(candidates) if candidates is not None \
        else default_candidates(cfg.cim_cfg) if cfg.cim_cfg \
        else default_candidates()
    dig = digital_candidate()
    budget_candidate = budget_candidate or prototype_candidate()
    candidates = _check_labels(candidates, budget_candidate)

    if ref is None:
        ref = reference_logits(params, cfg, tokens)
    if profile is None:
        profile = profile_sensitivities(params, cfg, tokens, candidates,
                                        sites=sites, noise_seed=noise_seed,
                                        ref=ref, verbose=verbose)
    else:
        if sites is not None:
            profile = _restrict(profile, sites)
        have = set(profile.labels)
        missing = [c for c in candidates if c.label not in have]
        if missing:
            extra = profile_sensitivities(
                params, cfg, tokens, missing, sites=profile.sites,
                noise_seed=noise_seed, ref=ref, verbose=verbose)
            profile = SensitivityProfile(
                sites=list(profile.sites),
                site_shapes=dict(profile.site_shapes),
                labels=list(profile.labels) + list(extra.labels),
                rms={s: {**profile.rms[s], **extra.rms[s]}
                     for s in profile.sites},
                site_mults=dict(profile.site_mults))
    sites = list(profile.sites)

    uniform_budget = {s: budget_candidate for s in sites}
    if rms_budget is not None:
        budget_pred = budget_meas = float(rms_budget)
    else:
        budget_pred = predicted_rms(uniform_budget, profile) * budget_scale
        budget_meas = budget_scale * rel_rms(
            planned_logits(params, cfg, tokens,
                           plan_from_assignment(uniform_budget), noise_seed),
            ref)

    assignment = {s: dig for s in sites}
    cost_of = lambda c: combined_cost(c, dig, cost_weights)
    moves: List[Tuple[str, str, float]] = []
    while True:
        best = None
        cur_sq = sum(profile.rms[s][assignment[s].label] ** 2 for s in sites)
        for s in sites:
            cur = assignment[s]
            for cand in candidates:
                dc = (cost_of(cur) - cost_of(cand)) * profile.macs_per_token(s)
                if dc <= 0:
                    continue
                drms = (profile.rms[s][cand.label] ** 2
                        - profile.rms[s][cur.label] ** 2)
                new_rms = math.sqrt(max(cur_sq + drms, 0.0))
                if new_rms > budget_pred:
                    continue
                score = dc / max(drms, 1e-12)
                if best is None or score > best[0]:
                    best = (score, s, cand)
        if best is None:
            break
        score, s, cand = best
        assignment[s] = cand
        moves.append((s, cand.label, score))
        if verbose:
            print(f"[search] {s} -> {cand.label} (score {score:.3g}, "
                  f"pred rms {predicted_rms(assignment, profile):.5f})")

    def measure(asg):
        return rel_rms(planned_logits(params, cfg, tokens,
                                      plan_from_assignment(asg), noise_seed),
                       ref)
    measured = measure(assignment)
    n_reverts = 0
    while measured > budget_meas * validate_tol and any(
            assignment[s].label != dig.label for s in sites):
        worst = max((s for s in sites if assignment[s].label != dig.label),
                    key=lambda s: profile.rms[s][assignment[s].label])
        assignment[worst] = dig
        n_reverts += 1
        measured = measure(assignment)
        if verbose:
            print(f"[search] revert {worst} -> digital "
                  f"(measured rms {measured:.5f})")

    return PlanSearchResult(
        plan=plan_from_assignment(assignment),
        assignment={s: assignment[s].label for s in sites},
        profile=profile,
        predicted_rms=predicted_rms(assignment, profile),
        measured_rms=measured,
        budget_predicted=budget_pred,
        budget_measured=budget_meas,
        cost=assignment_cost(assignment, profile, cost_weights),
        cost_digital=assignment_cost({s: dig for s in sites}, profile,
                                     cost_weights),
        cost_budget_plan=assignment_cost(uniform_budget, profile,
                                         cost_weights),
        moves=moves,
        n_reverts=n_reverts,
    )


def evaluate_plan(params, cfg: ModelConfig, tokens, plan: DeploymentPlan,
                  profile: SensitivityProfile,
                  cost_weights: Tuple[float, float, float]
                  = DEFAULT_COST_WEIGHTS,
                  noise_seed: Optional[int] = PROFILE_NOISE_SEED,
                  ref=None) -> Dict[str, float]:
    """Measured RMS and modeled cost of any plan over the profiled sites
    (float sites carry no macro cost); ``ref`` saves the float forward."""
    from ..core.costmodel import macro_cost
    if ref is None:
        ref = reference_logits(params, cfg, tokens)
    measured = rel_rms(planned_logits(params, cfg, tokens, plan, noise_seed),
                       ref)
    assignment = {}
    for s in profile.sites:
        e = plan.resolve(s)
        if e.fidelity == "float":
            continue
        assignment[s] = Candidate(entry=e, cost=macro_cost(e.cfg, e.fidelity))
    out = assignment_cost(assignment, profile, cost_weights)
    out["measured_rms"] = measured
    return out
