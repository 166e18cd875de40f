"""Sensitivity profiler: how much does each projection's D/A split hurt?

Counterpart of ``repro/plan/profiler.py``.  For every plan-addressable
projection site (``lm.iter_packable_paths``) and every candidate design
point, one calibration batch runs through ``lm.forward`` under a plan
that puts only that site on the candidate (every other site stays
float), and the relative RMS of the output logits against the float
forward is the site's sensitivity:

    rms(site, cand) = ||logits_planned - logits_float|| / ||logits_float||

The forwards take the raw weights, quantized per call: the same
``layers._dense`` route serving takes (kernel row 6 at the prototype's
numerics, a pack made for the call on rows 1 and 2 at the other design
points, the exact integer dot for the all-digital one).  Analog
candidates are charged for their noise: by default the forwards run
under ``PROFILE_NOISE_SEED`` (each projection draws the reference's
deterministic noise stream, in torch); ``noise_seed=None`` profiles
noise-free, through the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import lm
from ..models.config import ModelConfig
from .candidates import Candidate
from .plan import DeploymentPlan, FLOAT_ENTRY

PROFILE_NOISE_SEED = 0x50524F46  # "PROF"


def calibration_batch(cfg: ModelConfig, batch: int = 2, seq_len: int = 16,
                      seed: int = 0) -> np.ndarray:
    """Uniform-random calibration token ids, (batch, seq_len) int32 (the
    reference's placeholder draw; pass real tokens for a deployment plan
    calibrated on representative inputs)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, seq_len), dtype=np.int32)


def _float_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, cim_mode=False, cim_plan=None,
                               cim_noise_seed=None)


def _device(params) -> torch.device:
    return params["embed"].device


def _forward(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                           device=_device(params))
    with torch.inference_mode():
        logits, _ = lm.forward(params, cfg, toks, remat=False)
    return logits


def reference_logits(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    """The full-precision forward (the macro off everywhere)."""
    return _forward(params, _float_cfg(cfg), tokens)


def planned_logits(params, cfg: ModelConfig, tokens, plan: DeploymentPlan,
                   noise_seed: Optional[int] = PROFILE_NOISE_SEED
                   ) -> torch.Tensor:
    """The forward under ``plan`` on raw weights (the serving route)."""
    pcfg = dataclasses.replace(cfg, cim_mode=True, cim_plan=plan,
                               cim_cfg=None, cim_noise_seed=noise_seed)
    return _forward(params, pcfg, tokens)


def _norm(t: torch.Tensor) -> float:
    """The 2-norm of every element, summed in float64.  The reference
    sums float32 squares in XLA-CPU's order for a reduction over every
    axis, which ``tools/rms_order_probe.py`` measured and could not
    reduce to a rule, so the port does not reproduce it: the two agree
    to float32 rounding."""
    return float(torch.sqrt((t.to(torch.float64) ** 2).sum()))


def rel_rms(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| / ||ref|| over every element, of the float32 logits."""
    num = _norm((a - ref).to(torch.float32))
    den = _norm(ref.to(torch.float32))
    return num / max(den, 1e-12)


@dataclasses.dataclass
class SensitivityProfile:
    """Per-site, per-candidate end-to-end RMS degradation table."""

    sites: List[str]                       # plan paths, params-tree order
    site_shapes: Dict[str, Tuple[int, ...]]
    labels: List[str]                      # candidate labels, sweep order
    rms: Dict[str, Dict[str, float]]       # site -> label -> rel RMS
    # per-token executions of a site (default 1; a shared block runs once
    # per layer group)
    site_mults: Dict[str, int] = dataclasses.field(default_factory=dict)

    def weights_per_site(self, site: str) -> int:
        """Weights parked on the array for this site (area accounting)."""
        n = 1
        for d in self.site_shapes[site]:
            n *= d
        return n

    def macs_per_token(self, site: str) -> int:
        """MACs one token spends in this site: parked weights times its
        executions per token."""
        return self.weights_per_site(site) * self.site_mults.get(site, 1)

    def as_table(self) -> Dict[str, Dict[str, float]]:
        return {s: dict(self.rms[s]) for s in self.sites}


def profile_sensitivities(
    params, cfg: ModelConfig, tokens,
    candidates: Sequence[Candidate],
    sites: Optional[Sequence[str]] = None,
    noise_seed: Optional[int] = PROFILE_NOISE_SEED,
    ref: Optional[torch.Tensor] = None,
    verbose: bool = False,
) -> SensitivityProfile:
    """One forward per (site, candidate), each isolating a single site;
    ``ref`` passes in float reference logits already computed."""
    shapes = lm.iter_packable_paths(params)
    if sites is None:
        sites = list(shapes)
    if ref is None:
        ref = reference_logits(params, cfg, tokens)
    rms: Dict[str, Dict[str, float]] = {}
    for site in sites:
        if site not in shapes:
            raise ValueError(f"unknown projection site {site!r}; "
                             f"known: {sorted(shapes)}")
        row: Dict[str, float] = {}
        for cand in candidates:
            plan = DeploymentPlan.from_dict({site: cand.entry},
                                            default=FLOAT_ENTRY)
            out = planned_logits(params, cfg, tokens, plan, noise_seed)
            row[cand.label] = rel_rms(out, ref)
            if verbose:
                print(f"[profile] {site:20s} {cand.label:18s} "
                      f"rms {row[cand.label]:.5f}")
        rms[site] = row
    n_groups = (cfg.n_layers // cfg.shared_attn_period
                if cfg.shared_attn_period else 1)
    mults = {s: n_groups for s in sites if s.startswith("shared/")}
    return SensitivityProfile(
        sites=list(sites),
        site_shapes={s: shapes[s] for s in sites},
        labels=[c.label for c in candidates],
        rms=rms,
        site_mults=mults,
    )
