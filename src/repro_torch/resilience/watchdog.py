"""Online analog-health watchdog: a debounced GREEN/AMBER/RED machine.

Counterpart of ``repro/resilience/watchdog.py``.  The serving stack
already measures the signals that degrade first when the analog
substrate drifts:

  ADC clip rate      the telemetry rings' ``CTR_ADC_CLIP`` counter (kernel
                     rows 1-2 and the fast GEMM count clipped codes).
                     Gain/offset drift pushes sums past the SAR range, so
                     the clips per token rise before logits go visibly
                     wrong.
  acceptance rate    speculative serving's drafted and accepted counts.
                     The draft plan is all-analog, so drift hits it hardest
                     and acceptance collapses (the verify pass still gates
                     every token).
  golden probe       a seeded known-input GEMM through the real packed
                     weights, against the exact reference recorded at
                     deployment (``GoldenProbe``): it sees slow offset drift
                     that never clips, and stuck-at cells in the weights.

``Watchdog.observe`` folds one measurement window into the state machine.
Both directions are debounced: a breach must persist for ``debounce``
windows to escalate, and recovery needs ``recover`` clean windows per
level down.  Escalation can jump straight to RED; recovery is one level
at a time.  The machine runs on the host at the segment boundaries of
the guarded serve loop (``failover.GuardedServer``), on counters the
device keeps anyway.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch

GREEN, AMBER, RED = "GREEN", "AMBER", "RED"
_LEVEL = {GREEN: 0, AMBER: 1, RED: 2}
_STATE = {v: k for k, v in _LEVEL.items()}


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Thresholds and debounce of the health state machine.

    Clip thresholds are per-token rates above the clean baseline
    (``Watchdog(baseline_clip_rate=...)``); probe thresholds are ratios
    of the probe's rel-RMS over the clean floor measured at deployment
    (the fast path is never bit-equal to the exact reference)."""

    clip_rate_amber: float = 0.05     # excess ADC clips per emitted token
    clip_rate_red: float = 0.50
    accept_amber: float = 0.50        # speculative acceptance below these
    accept_red: float = 0.20
    probe_amber: float = 3.0          # probe rel-RMS / clean floor above
    probe_red: float = 10.0
    debounce: int = 2                 # consecutive breaches to escalate
    recover: int = 4                  # consecutive clean windows per level
    probe_every: int = 1              # run the golden probe every N windows

    def __post_init__(self):
        if self.debounce < 1 or self.recover < 1 or self.probe_every < 1:
            raise ValueError("debounce/recover/probe_every must be >= 1")


@dataclasses.dataclass
class HealthSample:
    """One observation window, with the raw per-signal classification."""
    n_tokens: int                     # cumulative tokens at window end
    n_iter: int                       # cumulative loop iterations
    clip_rate: Optional[float]        # excess clips per token this window
    accept_rate: Optional[float]      # acceptance this window (speculative)
    probe_ratio: Optional[float]      # probe rms / clean floor
    raw: str                          # worst un-debounced level
    state: str                        # machine state after this window
    reasons: List[str]

    def to_dict(self) -> Dict:
        rnd = lambda v: None if v is None else round(float(v), 5)
        return dict(n_tokens=self.n_tokens, n_iter=self.n_iter,
                    clip_rate=rnd(self.clip_rate),
                    accept_rate=rnd(self.accept_rate),
                    probe_ratio=rnd(self.probe_ratio),
                    raw=self.raw, state=self.state, reasons=self.reasons)


class Watchdog:
    """Debounced health-state machine over windowed serve telemetry."""

    def __init__(self, cfg: WatchdogConfig = WatchdogConfig(),
                 baseline_clip_rate: float = 0.0):
        self.cfg = cfg
        self.baseline_clip_rate = float(baseline_clip_rate)
        self.state = GREEN
        self.history: List[HealthSample] = []
        self._hot = 0                 # consecutive windows above state
        self._cool = 0                # consecutive windows below state
        self._pending = 0             # level the hot streak argues for

    def _classify(self, clip_rate, accept_rate, probe_ratio):
        c = self.cfg
        level, reasons = 0, []

        def breach(val, amber, red, name, below=False):
            nonlocal level
            if val is None or val != val:
                return
            if below:
                hit = 2 if val < red else (1 if val < amber else 0)
            else:
                hit = 2 if val > red else (1 if val > amber else 0)
            if hit:
                reasons.append(f"{name}={val:.4g} ({_STATE[hit]})")
                level = max(level, hit)

        breach(clip_rate, c.clip_rate_amber, c.clip_rate_red, "clip_rate")
        breach(accept_rate, c.accept_amber, c.accept_red, "accept_rate",
               below=True)
        breach(probe_ratio, c.probe_amber, c.probe_red, "probe_ratio")
        return level, reasons

    def observe(self, *, n_tokens: int, n_iter: int,
                clip_rate: Optional[float] = None,
                accept_rate: Optional[float] = None,
                probe_ratio: Optional[float] = None) -> str:
        """Fold one measurement window in; returns the (possibly new)
        debounced state.  ``clip_rate`` is per token for the window; the
        clean baseline is subtracted here."""
        if clip_rate is not None and clip_rate == clip_rate:
            clip_rate = max(0.0, clip_rate - self.baseline_clip_rate)
        raw, reasons = self._classify(clip_rate, accept_rate, probe_ratio)
        cur = _LEVEL[self.state]
        if raw > cur:
            # an escalation streak: a RED window refreshes an AMBER
            # streak's count (it is still above the current state)
            self._pending = max(self._pending, raw) if self._hot else raw
            self._hot += 1
            self._cool = 0
            if self._hot >= self.cfg.debounce:
                self.state = _STATE[self._pending]
                self._hot = self._pending = 0
        elif raw < cur:
            self._cool += 1
            self._hot = self._pending = 0
            if self._cool >= self.cfg.recover:
                self.state = _STATE[cur - 1]   # one level at a time
                self._cool = 0
        else:
            self._hot = self._cool = self._pending = 0
        self.history.append(HealthSample(
            n_tokens=n_tokens, n_iter=n_iter, clip_rate=clip_rate,
            accept_rate=accept_rate, probe_ratio=probe_ratio,
            raw=_STATE[raw], state=self.state, reasons=reasons))
        return self.state

    def observe_snapshot(self, snap, probe_ratio: Optional[float] = None
                         ) -> str:
        """Classify one whole-workload ``ObsSnapshot`` (obs/rings.py) as a
        single window."""
        tokens = snap.counters.get("tokens", 0)
        clip = snap.counters.get("adc_clip", 0)
        clip_rate = clip / tokens if tokens else None
        acc = snap.acceptance_rate
        return self.observe(
            n_tokens=tokens, n_iter=snap.n_iter, clip_rate=clip_rate,
            accept_rate=None if acc != acc else acc,
            probe_ratio=probe_ratio)

    @property
    def detection(self) -> Optional[HealthSample]:
        """First window the debounced state left GREEN (None if never)."""
        return next((s for s in self.history if s.state != GREEN), None)

    def to_dict(self) -> Dict:
        return dict(state=self.state,
                    baseline_clip_rate=round(self.baseline_clip_rate, 6),
                    windows=[s.to_dict() for s in self.history])


class GoldenProbe:
    """Known-input probe GEMM against the deployment-time exact reference.

    Built once from one real packed projection: a seeded activation batch
    (``prng.randint`` under ``fold_in(PRNGKey(seed), "PROB")``, the
    reference's draw), the exact-fidelity output and the clean fast-path
    rel-RMS floor.  Each call runs the fast path as served, under the
    fault model ``fault`` at clock ``t``, and returns its rel-RMS over the
    clean floor.  The clock is handed over as a device tensor, so every
    call runs the same operations whatever ``t`` (the reference jits the
    probe once with ``t`` traced).  ``serve_packed`` probes another pack
    (a stuck-at-faulted one) against the clean pack's reference."""

    def __init__(self, packed, *, fault=None, serve_packed=None,
                 m: int = 4, seed: int = 0):
        from ..core import prng
        from ..core.engine import packed_cim_matmul_int
        from ..plan.profiler import rel_rms

        self.packed = packed
        self._serve = serve_packed if serve_packed is not None else packed
        self._fault = fault
        self._mm = packed_cim_matmul_int
        self._rel_rms = rel_rms
        dev = packed.kernel_w.device
        key = prng.fold_in(prng.PRNGKey(seed, dev), 0x50524F42)  # "PROB"
        self.xq = prng.randint(key, (m, packed.k_dim), -127, 128)
        with torch.inference_mode():
            self.ref = self._mm(self.xq, packed, packed.cfg,
                                fidelity="exact").to(torch.float64)
            clean = self._mm(self.xq, packed, packed.cfg,
                             fidelity="fast").to(torch.float64)
        self.clean_floor = max(float(rel_rms(clean, self.ref)), 1e-9)
        self._t = torch.zeros((), dtype=torch.int32, device=dev)

    def __call__(self, t: int = 0) -> float:
        """rel-RMS of the served fast path at clock ``t`` over the clean
        floor (1.0 is healthy)."""
        from . import faults as rfaults
        with torch.inference_mode():
            armed = contextlib.nullcontext()
            if self._fault is not None:
                self._t.fill_(int(t))
                armed = rfaults.inject(self._fault, self._t)
            with armed:
                y = self._mm(self.xq, self._serve, self.packed.cfg,
                             fidelity="fast").to(torch.float64)
        return float(self._rel_rms(y, self.ref)) / self.clean_floor


def first_packed_leaf(params):
    """The first packed leaf of a params tree in the reference's leaf
    order (dict keys sorted at every level), layer 0 of a stacked one:
    the probe target.  None when the tree holds no packed weights."""
    from ..core.engine import FusedPackedCimWeights, PackedCimWeights

    def walk(v):
        if isinstance(v, dict):
            for k in sorted(v):
                got = walk(v[k])
                if got is not None:
                    return got
            return None
        if isinstance(v, FusedPackedCimWeights):
            v = v.packed
        if isinstance(v, PackedCimWeights):
            return v.layer(0) if v.kernel_w.dim() == 3 else v
        return None

    return walk(params)
