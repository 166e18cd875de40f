"""Resilience benchmark twin: the port's run of
``benchmarks/resilience_bench.py``.

  PYTHONPATH=src python -m repro_torch.launch.resilience_bench \
      [--no-smoke] [--device cpu] [--out PATH]

The reference's five sections and gates, on the port (CUDA by default;
``--device cpu`` runs the plain version); a gate that fails exits
non-zero, as the reference's does:

  off-path identity   arming and disarming a ``FaultModel`` leaves the
                      aten op sequence of every scheduler branch
                      (``obs.scheduler_fingerprint``) unchanged for the
                      contiguous, paged and speculative pools, and on a
                      CUDA device the captured step graph's node
                      fingerprint too; a fault-on run's op sequence (and
                      captured graph) must differ, the proof that the
                      injection is wired in.  The reference fingerprints
                      its lowered StableHLO instead.
  clean guarded       the watchdog-guarded serve of a fault-free queue
                      stays GREEN, takes no failover action, prepares each
                      rung once and emits the plain scheduler's tokens.
  detection           the seeded drift ramp ``_DRIFT`` drives the debounced
                      state to RED within 32 tokens and escalates to the
                      digital rung without a preparation or a capture.
  fidelity recovery   end-to-end logits rel-RMS against the float forward
                      (``plan/profiler.py``: ``calibration_batch``,
                      ``planned_logits``, ``reference_logits``,
                      ``rel_rms``): the digital rung under the same drift
                      comes within 2x the clean plan's RMS, and the drifted
                      plan is worse than it.
  per-rung cost       tok/s at every rung, median of repeats (not gated).

On a CUDA device the smoke model's heads are regrouped into 64-wide ones
(``serve_bench.paged_config``), since the paged-attention kernel (row 3)
takes head dims 64 and 128.  The result is printed as one JSON document
and written to ``--out`` where given; no committed file is read or
written.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.ccim import DEFAULT_CONFIG
from ..models import lm
from ..obs.fingerprint import (VARIANTS, fingerprint_variants,
                               graph_fingerprint, scheduler_fingerprint)
from ..plan.plan import DeploymentPlan, PlanEntry
from ..plan.profiler import (calibration_batch, planned_logits,
                             reference_logits, rel_rms)
from ..resilience import faults as rfaults
from ..resilience.failover import (GuardedServer, default_probe,
                                   derive_exact_plan)
from ..resilience.watchdog import (GREEN, RED, Watchdog, WatchdogConfig)
from .paging import PagedLayout
from .scheduler import (ContinuousBatchingScheduler, _params_device,
                        mixed_length_requests)
from .serve_bench import paged_config

# the seeded chaos scenario: per-column capacitor gain/offset drift
# ramping in mid-workload (onset and period in loop iterations)
_DRIFT = dict(seed=3, gain_amp=0.6, offset_lsb=2.0, schedule="ramp",
              onset=4, period=16)
# tokens the debounced watchdog gets to leave GREEN
_DETECTION_BUDGET_TOKENS = 32
# failover must restore end-to-end RMS to within this factor of the
# clean plan's RMS against the float forward
_RMS_RECOVERY_FACTOR = 2.0


def _workload(cfg, prompt_len, n_requests, seed):
    return mixed_length_requests(n_requests, prompt_len, cfg.vocab_size,
                                 stop_lengths=(4, 16, 8, 12), seed=seed)


def _fingerprint_scheduler(params, cfg, name: str, graphs: bool = False):
    kw = dict(slots=2, prompt_len=16, max_new_cap=4, seed=0)
    if name == "paged":
        kw["paged"] = PagedLayout(block_size=8, n_tbl=3, n_blocks=12)
    elif name == "speculative":
        kw["draft_k"] = 2
    return ContinuousBatchingScheduler(params, cfg, graphs=graphs, **kw)


def _step_graph_fingerprint(params, cfg) -> str:
    """The node fingerprint of a contiguous scheduler's captured pooled
    step (a new scheduler, captured under whatever is armed now)."""
    sched = _fingerprint_scheduler(params, cfg, "contiguous", graphs=True)
    sched.capture_graphs()
    return graph_fingerprint(sched._graphs[0])


def run_fingerprints(params, cfg, fault) -> dict:
    """Off-path identity: op sequences (and, on a CUDA device, the
    captured step graph) before and after an arm/disarm cycle, plus the
    wiring proof: a fault-on run differs."""
    make = lambda name: _fingerprint_scheduler(params, cfg, name)
    cuda = _params_device(params).type == "cuda"
    before = fingerprint_variants(make, 2)
    graph_off = _step_graph_fingerprint(params, cfg) if cuda else None
    with rfaults.inject(fault):
        seg_on = scheduler_fingerprint(make("contiguous"), 2)
        graph_on = _step_graph_fingerprint(params, cfg) if cuda else None
    after = fingerprint_variants(make, 2)
    graph_after = _step_graph_fingerprint(params, cfg) if cuda else None
    identical = before == after and graph_off == graph_after
    wired = seg_on != before["contiguous"] and (not cuda
                                                 or graph_on != graph_off)
    print(f"# fingerprints: off-path {'identical' if identical else 'MOVED'}"
          f" across {len(before)} variants"
          f"{' and the captured step' if cuda else ''}; fault-on run "
          f"{'differs (wired)' if wired else 'UNCHANGED (dead feature!)'}")
    if not identical:
        moved = sorted(v for v in before if before[v] != after[v])
        raise SystemExit(f"arming a FaultModel changed the fault-free "
                         f"serve loop: {moved or 'the captured step graph'}")
    if not wired:
        raise SystemExit("the fault-armed run ran the clean ops -- "
                         "injection is not wired in")
    return dict(plain_loop=before, identical_after_arm_cycle=True,
                segment_fault_off=before["contiguous"],
                segment_fault_on=seg_on, step_graph_fault_off=graph_off,
                step_graph_fault_on=graph_on, fault_segment_differs=True)


def run_clean_guarded(params, cfg, prompt_len, n_requests, seed,
                      segment_iters) -> dict:
    """Fault-free guarded serving: GREEN, no actions, token parity."""
    server = GuardedServer(
        params, cfg, slots=2, prompt_len=prompt_len, max_new_cap=16,
        seed=seed, watchdog=Watchdog(), probe=default_probe(params),
        segment_iters=segment_iters)
    reqs = _workload(cfg, prompt_len, n_requests, seed)
    report, log = server.run(reqs)
    want = server.scheduler().run(reqs).tokens_by_rid()
    got = report.tokens_by_rid()
    parity = all(np.array_equal(got[r], want[r]) for r in want)
    print(f"# clean guarded: state {server.watchdog.state}, "
          f"{len(log.actions)} actions, token parity "
          f"{'OK' if parity else 'FAILED'}, {report.tok_s:.1f} tok/s, "
          f"{log.n_compiles} compiles ({len(server.ladder)} rungs)")
    if server.watchdog.state != GREEN or log.actions:
        raise SystemExit(
            f"clean workload tripped the watchdog: state "
            f"{server.watchdog.state}, {len(log.actions)} failover actions")
    if not parity:
        raise SystemExit("guarded serving changed tokens on a fault-free "
                         "workload vs the plain scheduler")
    if log.n_compiles != len(server.ladder):
        raise SystemExit(f"expected one compile per rung "
                         f"({len(server.ladder)}), got {log.n_compiles}")
    return dict(state=server.watchdog.state, n_actions=len(log.actions),
                token_parity=True, tok_s=report.tok_s,
                n_compiles=log.n_compiles, captures=server.captures(),
                probe_clean_floor=server.probe.clean_floor,
                resilience=log.to_dict())


def run_detection(params, cfg, fault, prompt_len, n_requests, seed,
                  segment_iters) -> dict:
    """Seeded mid-stream drift: RED within the token budget, escalation
    to the immune rung, nothing prepared or captured at failover."""
    server = GuardedServer(
        params, cfg, slots=2, prompt_len=prompt_len, max_new_cap=16,
        seed=seed, fault=fault,
        watchdog=Watchdog(WatchdogConfig(debounce=1)),
        probe=default_probe(params, fault=fault),
        segment_iters=segment_iters)
    reqs = _workload(cfg, prompt_len, n_requests, seed)
    report, log = server.run(reqs)
    det = log.detection_tokens
    print(f"# detection: state {server.watchdog.state}, detected at "
          f"{det} tokens (budget {_DETECTION_BUDGET_TOKENS}), "
          f"{len(log.actions)} action(s), final rung "
          f"'{log.rung_labels[log.final_rung]}', {log.n_compiles} compiles")
    if server.watchdog.state != RED:
        raise SystemExit(f"seeded drift not escalated to RED "
                         f"(state {server.watchdog.state})")
    if det is None or det > _DETECTION_BUDGET_TOKENS:
        raise SystemExit(f"detection at {det} tokens blew the "
                         f"{_DETECTION_BUDGET_TOKENS}-token budget")
    if log.final_rung != len(server.ladder) - 1 or not log.actions:
        raise SystemExit("RED did not escalate to the top (digital) rung")
    if log.n_compiles != len(server.ladder):
        raise SystemExit(f"failover compiled mid-run: {log.n_compiles} "
                         f"compiles for {len(server.ladder)} rungs")
    return dict(fault=dataclasses.asdict(fault),
                state=server.watchdog.state, detection_tokens=det,
                budget_tokens=_DETECTION_BUDGET_TOKENS,
                final_rung=log.rung_labels[log.final_rung],
                n_actions=len(log.actions), n_compiles=log.n_compiles,
                tok_s=report.tok_s, resilience=log.to_dict())


def run_rms(raw_params, packed_params, cfg, fault, t_drift: int = 48
            ) -> dict:
    """End-to-end logits RMS against the float forward: the clean plan,
    the drifted plan (no failover) and the failover rung under the same
    drift, at clock ``t_drift``."""
    plan = cfg.cim_plan or DeploymentPlan.uniform(
        PlanEntry(cfg=cfg.cim_cfg or DEFAULT_CONFIG,
                  fidelity=cfg.cim_fidelity))
    dig = derive_exact_plan(plan)
    toks = calibration_batch(cfg, batch=2, seq_len=8)
    ref = reference_logits(raw_params, cfg, toks).to(torch.float64)

    def rms(p, armed):
        if armed:
            with rfaults.inject(fault), rfaults.clock(t_drift):
                y = planned_logits(packed_params, cfg, toks, p,
                                   noise_seed=None)
        else:
            y = planned_logits(packed_params, cfg, toks, p, noise_seed=None)
        return float(rel_rms(y.to(torch.float64), ref))

    clean = rms(plan, armed=False)
    drift = rms(plan, armed=True)
    failover = rms(dig, armed=True)
    ratio = failover / clean if clean > 0 else float("inf")
    print(f"# rms (t={t_drift}): clean {clean:.4f}, drifted "
          f"{drift:.4f}, failover {failover:.4f} "
          f"({ratio:.2f}x clean, gate <= {_RMS_RECOVERY_FACTOR}x)")
    if failover > _RMS_RECOVERY_FACTOR * clean:
        raise SystemExit(
            f"failover rung RMS {failover:.4f} exceeds "
            f"{_RMS_RECOVERY_FACTOR}x the clean plan's {clean:.4f}")
    if drift <= failover:
        raise SystemExit(
            f"drifted plan RMS {drift:.4f} not worse than the failover "
            f"rung's {failover:.4f} -- the scenario exercises nothing")
    return dict(t_drift=t_drift, fault=dataclasses.asdict(fault),
                rms_clean=clean, rms_drift_no_failover=drift,
                rms_drift_failover=failover, failover_vs_clean=ratio,
                gate_factor=_RMS_RECOVERY_FACTOR)


def run_ladder_cost(params, cfg, prompt_len, n_requests, seed,
                    segment_iters, repeats) -> list:
    """Throughput at every rung of the ladder (the price of each
    degradation level), clean runs, median of repeats; not gated."""
    server = GuardedServer(
        params, cfg, slots=2, prompt_len=prompt_len, max_new_cap=16,
        seed=seed, segment_iters=segment_iters)
    reqs = _workload(cfg, prompt_len, n_requests, seed)
    server.compile_for(n_requests)
    rows = []
    for i, rung in enumerate(server.ladder):
        server.start_rung = i          # every rung is prepared above
        runs = [server.run(reqs)[0].tok_s for _ in range(repeats)]
        med = statistics.median(runs)
        rows.append(dict(rung=i, label=rung.label, tok_s_median=med,
                         tok_s_runs=runs))
        print(f"# ladder rung {i} ({rung.label}): {med:.1f} tok/s "
              f"(median of {repeats})")
    if server.n_compiles != len(server.ladder):
        raise SystemExit(f"ladder sweep recompiled: {server.n_compiles} "
                         f"compiles for {len(server.ladder)} rungs")
    return rows


def run(arch: str = "minicpm-2b", smoke: bool = True, prompt_len: int = 8,
        n_requests: int = 4, repeats: int = 3, seed: int = 0,
        segment_iters: int = 4, device=None, params=None,
        path: Optional[str] = None) -> dict:
    """Every section with its gates; ``params`` (float params) replaces
    the init from ``seed``.  Returns the result (written to ``path`` as
    JSON where given)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(paged_config(arch, smoke, dev), cim_mode=True)
    with torch.inference_mode():
        raw = (lm.init(seed, cfg, device=dev) if params is None
               else lm._to_device(params, dev))
        packed = lm.pack_cim_params(raw, cfg, dev)
    if dev.type == "cuda":
        from ..kernels import build
        build.load_all()
    fault = rfaults.FaultModel(**_DRIFT)
    result = dict(
        config=dict(arch=arch, smoke=smoke, prompt_len=prompt_len,
                    n_requests=n_requests, repeats=repeats, seed=seed,
                    segment_iters=segment_iters, device=str(dev),
                    d_head=cfg.d_head, variants=list(VARIANTS)),
        fingerprints=run_fingerprints(packed, cfg, fault),
        clean_guarded=run_clean_guarded(packed, cfg, prompt_len,
                                        n_requests, seed, segment_iters),
        detection=run_detection(packed, cfg, fault, prompt_len,
                                n_requests, seed, segment_iters),
        rms=run_rms(raw, packed, cfg, fault),
        ladder=run_ladder_cost(packed, cfg, prompt_len, n_requests, seed,
                               segment_iters, repeats))
    if path is not None:
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="--no-smoke runs the full-size arch")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--segment-iters", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args()
    result = run(args.arch, args.smoke, args.prompt_len, args.requests,
                 args.repeats, segment_iters=args.segment_iters,
                 device=args.device, path=args.out)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
