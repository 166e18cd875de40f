"""Deployment-plan Pareto twin: global single-config against planned-mixed.

Twin of ``benchmarks/plan_pareto.py``, over the reference bench's two
archs, ``BENCH_ARCHS``: minicpm-2b (attention and MLP projections) and
mamba2-130m (the SSM input group and ``out_proj``).  For each:

  1. profile each projection's output-RMS sensitivity over the
     reference's candidate grid (D/A split 6, 3, 0 at acc_len 16 and 32,
     the ADC width by the no-clip rule, and the all-digital point), by
     ``lm.forward`` on the raw weights under the profiler's analog-noise
     seed (``--noise-free`` profiles through the kernels instead);
  2. evaluate four deployment points on (measured RMS, modeled cost) and
     the first three on decode tok/s, served packed by ``launch/serve.py``
     on the same weights and plan:
       global_digital  all-digital CIM everywhere
       global_hybrid   the 28 nm prototype everywhere
       planned_mixed   the greedy plan at the global-hybrid budget
       planned_tight   the greedy plan at 60 % of that budget (RMS and
                       cost only);
  3. print the result as JSON (one entry per arch) and exit 1 when
     planned_mixed is dominated by global_hybrid (worse RMS and worse
     modeled cost) on any arch.

    PYTHONPATH=src python -m repro_torch.launch.plan_pareto --device cpu
    PYTHONPATH=src python -m repro_torch.launch.plan_pareto --scale card
    PYTHONPATH=src python -m repro_torch.launch.plan_pareto --archs mamba2-130m

``--scale smoke`` (the default) runs the smoke configs, as the reference
bench does; ``--scale card`` the full width and depth (minicpm-2b's 40
layers, mamba2-130m's 24).  It writes no file.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

import torch

from .. import plan as P
from .. import resolve_device
from ..configs import get_config
from ..models import lm
from .serve import serve

BENCH_ARCHS = ("minicpm-2b", "mamba2-130m")


def bench_candidates() -> list:
    """The reference bench's trimmed grid (one forward per site and
    candidate)."""
    return P.default_candidates(n_dcim_sweep=(6, 3, 0),
                                acc_len_sweep=(16, 32))


def measure_tok_s(arch: str, params, plan, smoke: bool, batch: int,
                  prompt_len: int, gen: int, device) -> float:
    """Decode tok/s of ``serve`` under ``plan``, packed, on ``params``."""
    _, stats = serve(arch, smoke=smoke, batch=batch, prompt_len=prompt_len,
                     gen=gen, plan=plan, params=params, device=device,
                     return_stats=True)
    return stats["decode_tok_s"]


def run_arch(arch: str = BENCH_ARCHS[0], smoke: bool = True, batch: int = 2,
             prompt_len: int = 16, gen: int = 16, seed: int = 0,
             device=None, params=None,
             candidates: Optional[Sequence] = None,
             noise_seed: Optional[int] = P.PROFILE_NOISE_SEED) -> dict:
    """The reference bench's ``run_arch`` for ``arch``.  ``params``
    injects float params (default: ``lm.init(seed)`` on ``device``);
    ``candidates`` replaces the grid."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if params is None:
        params = lm.init(seed, cfg, device=dev)
    tokens = P.calibration_batch(cfg, batch=batch, seq_len=prompt_len,
                                 seed=seed)
    cands = list(candidates) if candidates is not None else bench_candidates()
    ref = P.reference_logits(params, cfg, tokens)
    profile = P.profile_sensitivities(params, cfg, tokens, cands, ref=ref,
                                      noise_seed=noise_seed)
    res = P.pareto_search(params, cfg, tokens, candidates=cands,
                          profile=profile, ref=ref, noise_seed=noise_seed)
    res_tight = P.pareto_search(params, cfg, tokens, candidates=cands,
                                profile=profile, ref=ref, budget_scale=0.6,
                                noise_seed=noise_seed)
    plans = {
        "global_digital": P.DeploymentPlan.uniform(
            P.digital_candidate().entry),
        "global_hybrid": P.DeploymentPlan.uniform(
            P.prototype_candidate().entry),
        "planned_mixed": res.plan,
        "planned_tight": res_tight.plan,
    }
    points: Dict[str, dict] = {}
    for name, plan in plans.items():
        pt = P.evaluate_plan(params, cfg, tokens, plan, profile, ref=ref,
                             noise_seed=noise_seed)
        if name != "planned_tight":             # RMS and cost axes only
            pt["decode_tok_s"] = measure_tok_s(arch, params, plan, smoke,
                                               batch, prompt_len, gen, dev)
        points[name] = {k: round(float(v), 6) for k, v in pt.items()}
    points["planned_mixed"]["assignment"] = dict(res.assignment)
    points["planned_tight"]["assignment"] = dict(res_tight.assignment)

    pm, gh = points["planned_mixed"], points["global_hybrid"]
    dominated = (pm["measured_rms"] > gh["measured_rms"]
                 and pm["combined"] > gh["combined"])
    dominates = (pm["combined"] < gh["combined"]
                 and pm["measured_rms"] <= gh["measured_rms"])
    return dict(
        sites={s: profile.macs_per_token(s) for s in profile.sites},
        sensitivity=profile.as_table(),
        points=points,
        planned_dominated_by_global_hybrid=dominated,
        planned_dominates_global_hybrid=dominates,
        search=dict(n_moves=len(res.moves), n_reverts=res.n_reverts,
                    budget_measured=round(res.budget_measured, 6)),
        plans={k: v.summary() for k, v in plans.items()},
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", choices=("smoke", "card"), default="smoke",
                    help="smoke configs (the reference's) or full width")
    ap.add_argument("--archs", nargs="+", choices=BENCH_ARCHS,
                    default=list(BENCH_ARCHS))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise-free", action="store_true",
                    help="profile and evaluate without the analog noise "
                         "(the forwards then run through the kernels)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device ('cpu' for the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    outs = {arch: run_arch(arch, smoke=args.scale == "smoke",
                           batch=args.batch, prompt_len=args.prompt_len,
                           gen=args.gen, seed=args.seed, device=dev,
                           noise_seed=None if args.noise_free
                           else P.PROFILE_NOISE_SEED)
            for arch in args.archs}
    print(json.dumps(dict(bench="plan_pareto", scale=args.scale,
                          device=(torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                          noise_free=args.noise_free, archs=outs)),
          flush=True)
    bad = []
    for arch, out in outs.items():
        pm, gh = (out["points"]["planned_mixed"],
                  out["points"]["global_hybrid"])
        dominated = out["planned_dominated_by_global_hybrid"]
        print(f"# {arch}: planned-mixed rms {pm['measured_rms']:.4f} @ cost "
              f"{pm['combined']:.3f} vs global-hybrid rms "
              f"{gh['measured_rms']:.4f} @ cost {gh['combined']:.3f} -> "
              f"{'DOMINATES' if out['planned_dominates_global_hybrid'] else 'on front'}"
              f"{' [DOMINATED!]' if dominated else ''}", flush=True)
        if dominated:
            bad.append(arch)
    if bad:
        print(f"plan_pareto: planned-mixed point DOMINATED by global-hybrid "
              f"on {bad} (worse accuracy and worse modeled cost)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
