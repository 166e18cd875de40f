"""Graceful plan-degradation failover over one packed weight set.

Counterpart of ``repro/resilience/failover.py``.  The pack-compatibility
rule (``core.engine.pack_compatible``) that lets a speculative draft
share its verify plan's pack also defines the recovery space when the
analog substrate degrades: from one hybrid ``PackedCimWeights`` pack,
three execution modes are servable with zero repacks:

  analog    the all-analog shadow (``plan.derive_draft_plan``): cheapest
            conversions, fully exposed to capacitor/ADC drift;
  hybrid    the deployed mixed D/A plan (the paper's design point);
  digital   the entry-wise ``fidelity="exact"`` plan: every projection
            rebuilds the integer weights (``packed.wq()``) and multiplies
            them exactly, so no conversion-path fault reaches it
            (stuck-at cells live in the shared array and survive).

``derive_ladder`` orders them as a degradation ladder; escalation raises
fidelity, never lowers it.  In speculative mode the first escalation
swaps the all-analog draft for self-speculation (draft == verify plan),
which keeps the round shapes and ``draft_k``, and so the pool state.

``GuardedServer`` drives the ladder: one scheduler per rung over the
same params, all on ONE pool state (``share_state``).  ``compile_for``
prepares every rung before serving: on the card it captures each rung's
step graph (or speculative round) and per-slot prefill-chunk graphs, so
failover captures nothing.  The workload runs as budget-bounded
segments of the scheduler loop (``_iterate``); at each boundary the
driver reads the health counters in one transfer, optionally runs the
golden probe, feeds the watchdog and, on AMBER or RED, continues the
next segment in another rung's scheduler on the same state: the port's
"call a different precompiled function on the same carry".
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..launch.scheduler import ContinuousBatchingScheduler, Request, ServeReport
from ..obs import rings as obs_rings
from ..obs.rings import ObsConfig
from ..plan.draft import derive_draft_plan
from ..plan.plan import DeploymentPlan, PlanEntry
from . import faults as rfaults
from .watchdog import (GREEN, RED, GoldenProbe, Watchdog, first_packed_leaf)


def derive_exact_entry(entry: PlanEntry) -> PlanEntry:
    """The exact-fidelity sibling of one plan entry: the same CCIMConfig
    (so the pack guard passes with zero repacks); float entries stay."""
    if entry.fidelity == "float":
        return entry
    return PlanEntry(cfg=entry.cfg, fidelity="exact", label="digital")


def derive_exact_plan(plan: DeploymentPlan) -> DeploymentPlan:
    """Entry-wise exact (all-digital) sibling of a deployment plan."""
    return DeploymentPlan.from_dict(
        {p: derive_exact_entry(e) for p, e in plan.entries},
        default=derive_exact_entry(plan.default))


@dataclasses.dataclass(frozen=True)
class Rung:
    """One ladder position: a serve plan (and, speculative, the draft
    plan); all rungs of one ladder serve the same pack."""
    label: str
    plan: DeploymentPlan
    draft_plan: Optional[DeploymentPlan] = None


def derive_ladder(plan: DeploymentPlan, *, speculative: bool = False
                  ) -> Tuple[List[Rung], int]:
    """The pack-compatible degradation ladder of a deployment plan:
    ``(rungs, start)``, rungs cheapest to most exact, ``start`` the
    deployed plan's own position.  Non-speculative: analog -> hybrid ->
    digital; speculative: analog-draft -> self-draft -> digital."""
    dig = derive_exact_plan(plan)
    if speculative:
        return [Rung("spec/analog-draft", plan, derive_draft_plan(plan)),
                Rung("spec/self-draft", plan, plan),
                Rung("digital", dig, dig)], 0
    return [Rung("analog", derive_draft_plan(plan)),
            Rung("hybrid", plan),
            Rung("digital", dig)], 1


@dataclasses.dataclass
class FailoverAction:
    """One ladder move, stamped with where in the workload it happened."""
    n_iter: int
    n_tokens: int
    from_rung: int
    to_rung: int
    state: str
    reasons: List[str]

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ResilienceLog:
    """What the guarded run did: ladder moves, watchdog windows, census."""
    rung_labels: List[str]
    start_rung: int
    final_rung: int
    actions: List[FailoverAction]
    n_segments: int
    segment_iters: int
    n_compiles: int                   # all incurred before serving started
    watchdog: Optional[Dict] = None   # Watchdog.to_dict()

    @property
    def detection_tokens(self) -> Optional[int]:
        """Tokens emitted when the watchdog first left GREEN."""
        if not self.watchdog:
            return None
        w = next((s for s in self.watchdog["windows"]
                  if s["state"] != GREEN), None)
        return None if w is None else w["n_tokens"]

    def to_dict(self) -> Dict:
        return dict(rung_labels=self.rung_labels, start_rung=self.start_rung,
                    final_rung=self.final_rung,
                    actions=[a.to_dict() for a in self.actions],
                    n_segments=self.n_segments,
                    segment_iters=self.segment_iters,
                    n_compiles=self.n_compiles,
                    detection_tokens=self.detection_tokens,
                    watchdog=self.watchdog)


class GuardedServer:
    """Watchdog-guarded serving over a failover ladder of schedulers.

    One scheduler per rung (same params, slot geometry and telemetry,
    pack-compatible plans), all on one pool state, driven in segments of
    ``segment_iters`` loop iterations.  ``fault`` arms a ``FaultModel``
    around every segment (and every capture), so the injected drift
    follows the loop's device clock; the probe and the health read run
    outside it.  The digital rung's exact path has no conversion
    epilogue, so escalation restores fidelity.  ``n_compiles`` counts one
    preparation per (rung, queue length); nothing below ``run`` prepares
    or captures more."""

    def __init__(self, params, cfg, *, slots: int, prompt_len: int,
                 max_new_cap: int, temperature: float = 0.0, seed: int = 0,
                 pad_token: int = 0, draft_k: int = 0, paged=None,
                 prefill_chunk: Optional[int] = None,
                 prefix_sharing: bool = True,
                 obs: Optional[ObsConfig] = None,
                 ladder: Optional[List[Rung]] = None,
                 start_rung: Optional[int] = None,
                 watchdog: Optional[Watchdog] = None,
                 probe: Optional[GoldenProbe] = None,
                 fault: Optional[rfaults.FaultModel] = None,
                 segment_iters: int = 32, graphs: Optional[bool] = None):
        if segment_iters < 1:
            raise ValueError(f"segment_iters {segment_iters} < 1")
        plan = cfg.cim_plan
        if plan is None:
            from ..core.ccim import DEFAULT_CONFIG
            plan = DeploymentPlan.uniform(PlanEntry(
                cfg=cfg.cim_cfg or DEFAULT_CONFIG,
                fidelity=cfg.cim_fidelity))
        if ladder is None:
            ladder, default_start = derive_ladder(
                plan, speculative=draft_k > 0)
        else:
            default_start = 0
        self.ladder = ladder
        self.start_rung = (start_rung if start_rung is not None
                           else default_start)
        if not (0 <= self.start_rung < len(ladder)):
            raise ValueError(f"start_rung {self.start_rung} outside ladder "
                             f"of {len(ladder)}")
        self.obs = obs if obs is not None else ObsConfig()
        self.watchdog = watchdog
        self.probe = probe
        self.fault = fault
        self.segment_iters = segment_iters
        self.n_compiles = 0
        self._prepared = set()
        self._scheds: List[ContinuousBatchingScheduler] = []
        for rung in ladder:
            rcfg = dataclasses.replace(cfg, cim_plan=rung.plan)
            sched = ContinuousBatchingScheduler(
                params, rcfg, slots, prompt_len, max_new_cap,
                temperature=temperature, seed=seed, pad_token=pad_token,
                draft_k=draft_k, draft_plan=rung.draft_plan, paged=paged,
                prefill_chunk=prefill_chunk, prefix_sharing=prefix_sharing,
                obs=self.obs, graphs=graphs)
            if self._scheds:
                sched.share_state(self._scheds[0])
            self._scheds.append(sched)

    def scheduler(self, rung: Optional[int] = None
                  ) -> ContinuousBatchingScheduler:
        return self._scheds[self.start_rung if rung is None else rung]

    def _armed(self):
        return (rfaults.inject(self.fault) if self.fault is not None
                else contextlib.nullcontext())

    def captures(self) -> int:
        """Graphs captured so far, over every rung."""
        return sum(len(s._graphs) + len(s._chunk_graphs)
                   for s in self._scheds)

    def compile_for(self, n_requests: int) -> None:
        """Prepare every rung for a queue length: failover later is a
        choice of scheduler, never a capture.  On the card each rung's
        graphs are captured here, under the fault model (if any)."""
        with self._armed():
            for i in range(len(self.ladder)):
                if (i, n_requests) not in self._prepared:
                    self._scheds[i].capture_graphs()
                    self._prepared.add((i, n_requests))
                    self.n_compiles += 1

    def _health(self, lp) -> Dict[str, int]:
        """The boundary's one device read: the rings' token and clip
        counters (plus the eager branches' host-side records), the pool's
        occupancy and the draft counters."""
        st, sched = lp.st, self._scheds[0]
        parts = [st["obs"]["ctr"],
                 (st["pending"] | st["live"]).any().to(torch.int32)[None]]
        if sched.draft_k:
            parts += [st["n_drafted"][None], st["n_accepted"][None]]
        h = torch.cat([p.to(torch.int32) for p in parts]).tolist()
        ctr = h[:obs_rings.N_CTR]
        rec = lp.rec.ctr
        occupied = bool(h[obs_rings.N_CTR]) or any(lp.filling)
        return dict(
            tokens=ctr[obs_rings.CTR_TOKENS] + rec[obs_rings.CTR_TOKENS],
            clip=ctr[obs_rings.CTR_ADC_CLIP] + rec[obs_rings.CTR_ADC_CLIP],
            drafted=h[-2] if sched.draft_k else 0,
            accepted=h[-1] if sched.draft_k else 0,
            done=not occupied and lp.q_head >= lp.n)

    def run(self, requests: Sequence[Request],
            arrival_iters: Optional[Sequence[int]] = None
            ) -> Tuple[ServeReport, ResilienceLog]:
        """Serve to completion under the watchdog.  Returns the
        ``ServeReport`` (token-equal to the start rung's plain ``run``
        while the watchdog stays GREEN) and the resilience log."""
        n = len(requests)
        self.compile_for(n)
        compiles_at_start, captures_at_start = self.n_compiles, self.captures()
        sched0 = self._scheds[self.start_rung]
        sched0._check(requests)
        with torch.inference_mode():
            lp = sched0._begin(requests, arrival_iters)
        rung = self.start_rung
        worst = 0                      # monotone: sticky degradation
        actions: List[FailoverAction] = []
        prev = dict(tokens=0, clip=0, drafted=0, accepted=0)
        n_segments = budget = 0
        while True:
            budget += self.segment_iters
            sched = self._scheds[rung]
            with torch.inference_mode(), self._armed(), \
                    sched._collector(lp.st):
                sched._iterate(lp, budget)
            n_segments += 1
            h = self._health(lp)
            if self.watchdog is not None:
                d = {k: h[k] - prev[k] for k in prev}
                prev = {k: h[k] for k in prev}
                probe_ratio = None
                if (self.probe is not None and (n_segments - 1)
                        % self.watchdog.cfg.probe_every == 0):
                    probe_ratio = self.probe(t=lp.n_iter)
                state = self.watchdog.observe(
                    n_tokens=h["tokens"], n_iter=lp.n_iter,
                    clip_rate=(d["clip"] / d["tokens"] if d["tokens"] > 0
                               else None),
                    accept_rate=(d["accepted"] / d["drafted"]
                                 if d["drafted"] > 0 else None),
                    probe_ratio=probe_ratio)
                level = 2 if state == RED else (0 if state == GREEN else 1)
                if level > worst:
                    worst = level
                    last = len(self.ladder) - 1
                    target = last if worst >= 2 else min(rung + 1, last)
                    if target != rung:
                        actions.append(FailoverAction(
                            n_iter=lp.n_iter, n_tokens=h["tokens"],
                            from_rung=rung, to_rung=target, state=state,
                            reasons=list(self.watchdog.history[-1].reasons)))
                        rung = target
            if h["done"]:
                break
        sched = self._scheds[rung]
        with torch.inference_mode(), self._armed(), sched._collector(lp.st):
            sched._iterate(lp)        # the loop's last flags read
            report, _ = sched._finish(lp)
        assert self.n_compiles == compiles_at_start, (
            "guarded serve prepared a rung mid-run")
        assert self.captures() == captures_at_start, (
            "guarded serve captured a graph mid-run")
        log = ResilienceLog(
            rung_labels=[r.label for r in self.ladder],
            start_rung=self.start_rung, final_rung=rung, actions=actions,
            n_segments=n_segments, segment_iters=self.segment_iters,
            n_compiles=self.n_compiles,
            watchdog=(self.watchdog.to_dict() if self.watchdog is not None
                      else None))
        return report, log


def default_probe(params, *, fault=None, serve_params=None,
                  m: int = 4, seed: int = 0) -> Optional[GoldenProbe]:
    """Golden probe over the first packed projection of ``params`` (the
    deployment-time reference); ``serve_params`` (a stuck-at-faulted
    pack) supplies the leaf actually probed.  None when the tree holds no
    packed weights."""
    ref = first_packed_leaf(params)
    if ref is None:
        return None
    serve = (first_packed_leaf(serve_params)
             if serve_params is not None else None)
    return GoldenProbe(ref, fault=fault, serve_packed=serve, m=m, seed=seed)
