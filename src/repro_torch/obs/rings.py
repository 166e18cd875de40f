"""Device-resident telemetry rings: the hot-path half of the obs subsystem.

Counterpart of ``repro/obs/rings.py``, with the same constants, columns
and counter slots.  A scheduler built with ``obs=ObsConfig(...)`` holds
one ``obs`` dict of int32 device tensors beside its pool state:

  ev       (event_cap + 1, 3)  event ring rows ``(kind, rid, iter)``:
                               request admission, first token, finish --
                               written at exactly the sites that set the
                               host's ``res_first``/``res_iter`` stamps,
                               so ring-derived TTFT iterations EQUAL
                               ``run_instrumented``'s ``first_iter``.
  ev_n     ()                  monotone event cursor.  A write lands at
                               ``where(do & (cursor < cap), cursor,
                               cap)``: row ``cap`` is a spare sink row,
                               so once the ring is full the write is
                               discarded, the cursor keeps counting, and
                               ``max(ev_n - cap, 0)`` is the drop count
                               -- the reference's scatter ``mode="drop"``
                               without a host branch.
  it       (iter_cap + 1, 6)   per-iteration sample ring, row = (branch,
                               live slots, tokens emitted, draft delta,
                               accept delta, free pool blocks), indexed
                               by the iteration number with the same
                               sink-row saturation.
  ctr      (N_CTR,)            scalar counters (below); they never
                               saturate, so totals stay exact when the
                               sample rings overflow.
  tick_tok ()                  the tokens the iteration's branch emitted,
                               consumed by ``iter_tick``.
  n_iter   ()                  the device's iteration clock (int64).  The
                               port's loop runs on the host, and a Python
                               int captured into a CUDA graph is frozen at
                               capture time, so the iteration number a
                               replayed step stamps is this tensor: a step
                               advances it in place, and the host sets it
                               before a step that follows other branches.

Counter slots: TOKENS (emitted, all branches), STALL (iterations where
live decoders existed but zero tokens were emitted), ADC_CLIP (codes the
macro GEMMs' conversions clipped, via ``obs/taps.py``; kernel rows 1 and
2 count them on the card), PREFIX_BLOCKS (shared-prefix blocks reused
instead of recomputed), SHARED_ADMITS (admissions that copied a donor
chain), MIN_FREE (low-water mark of the paged free list, a gauge
initialised to int32 max).

Every update is an in-place device op -- a copy into a ring row at a
device index, an add or a min into a counter -- so the same code runs
eagerly and inside a captured step graph, and none of it synchronizes
with the host.  The port's loop runs on the host, and the branches it
runs eagerly (harvest, admit, the prefill chunk) decide every value
their records hold there -- the request, the iteration, the branch, the
live and emitted counts, the prefix blocks; the free count after them
is the next flags read's.  Their records (events, sample rows, counter
deltas) are kept in ``EagerRecords`` and written into the device rings
in one batch after the loop (``EagerRecords.apply``: one copy to the
device, a few ops), so an eager iteration launches nothing for
telemetry; the captured step writes its own rows on the device.
``harvest_obs`` reads the rings in one transfer after that.

Calibration: the device has no clock, so rings record ITERATION stamps.
``harvest_obs`` converts to seconds with the uniform-iteration estimate
``wall_s / n_iter``; ``run_instrumented`` is the ground truth for
per-iteration seconds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

# event kinds
EV_ADMIT, EV_FIRST, EV_FINISH = 0, 1, 2
EV_NAMES = {EV_ADMIT: "admit", EV_FIRST: "first_token", EV_FINISH: "finish"}

# counter slots
CTR_TOKENS, CTR_STALL, CTR_ADC_CLIP = 0, 1, 2
CTR_PREFIX_BLOCKS, CTR_SHARED_ADMITS, CTR_MIN_FREE = 3, 4, 5
N_CTR = 6

# per-iteration sample columns
IT_BRANCH, IT_LIVE, IT_TOK, IT_DRAFTED, IT_ACCEPTED, IT_FREE = range(6)
_IT_COLS = 6

_I32_MAX = np.int32(2**31 - 1)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Static ring capacities: part of the rings' shapes, so two
    ObsConfigs capture two sets of step graphs (like slots or
    prompt_len)."""
    event_cap: int = 256
    iter_cap: int = 1024

    def __post_init__(self):
        if self.event_cap < 1 or self.iter_cap < 1:
            raise ValueError("ring capacities must be >= 1")


#: the reference's ring leaves (``n_iter`` is the port's device clock)
OBS_LEAVES = ("ctr", "ev", "ev_n", "it", "tick_tok")

# leaf -> (shape of a config, value at the start of a run)
_LEAVES = (("ev", lambda c: (c.event_cap + 1, 3), 0),
           ("ev_n", lambda c: (), 0),
           ("it", lambda c: (c.iter_cap + 1, _IT_COLS), 0),
           ("ctr", lambda c: (N_CTR,), 0),
           ("tick_tok", lambda c: (), 0),
           ("n_iter", lambda c: (), 0))


def init_obs_state(cfg: ObsConfig, device=None) -> Dict[str, torch.Tensor]:
    """Fresh rings for ``cfg`` on ``device`` (int32, zeroed; the MIN_FREE
    slot at int32 max; the clock int64, an index)."""
    obs = {name: torch.empty(shape(cfg), device=device,
                             dtype=torch.int64 if name == "n_iter"
                             else torch.int32)
           for name, shape, _ in _LEAVES}
    reset_obs_state(obs)
    return obs


def reset_obs_state(obs: Dict[str, torch.Tensor]) -> None:
    """Put ``obs`` back to its start-of-run values in place (a captured
    step graph keeps writing the same tensors)."""
    for name, _, value in _LEAVES:
        obs[name].fill_(value)
    obs["ctr"][CTR_MIN_FREE] = int(_I32_MAX)


# small int32 constants on each device, made once (never while a graph
# is being captured: a tensor made during capture holds no value until
# the graph replays)
_CONSTS: Dict[tuple, torch.Tensor] = {}


def _i32(v, device) -> torch.Tensor:
    """``v`` as a 0-d int32 tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v if v.dtype == torch.int32 else v.to(torch.int32)
    v = int(v)
    dev = torch.device(device)
    if (dev.type == "cuda" and torch.cuda.is_current_stream_capturing()) \
            or not 0 <= v < 256:
        return torch.full((), v, dtype=torch.int32, device=dev)
    key = (dev, v)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.full((), v, dtype=torch.int32, device=dev)
    return t


def ring_push(obs: Dict, kind: int, rid, it, do=True) -> Dict:
    """Append ``(kind, rid, it)`` to the event ring when ``do`` holds (a
    bool, or a bool tensor on the device), in place; returns ``obs``.

    The conditional and the saturation share one mechanism: the write
    row is the cursor when ``do`` holds and the ring has room, else the
    sink row past the end -- so a full ring silently stops recording
    while the cursor keeps counting attempts."""
    if do is False:
        return obs
    ev, n = obs["ev"], obs["ev_n"]
    cap, dev = ev.shape[0] - 1, ev.device
    row = torch.stack([_i32(kind, dev), _i32(rid, dev), _i32(it, dev)])
    if do is True:
        idx = torch.clamp(n, max=cap)
        n.add_(1)
    else:
        do = torch.as_tensor(do, device=dev).to(torch.bool)
        idx = torch.where(do & (n < cap), n, cap)
        n.add_(do.to(torch.int32))
    ev.index_copy_(0, idx.reshape(1).long(), row.reshape(1, 3))
    return obs


def ctr_add(obs: Dict, slot: int, amount) -> Dict:
    """Add ``amount`` (int or tensor) into counter ``slot``, in place."""
    if isinstance(amount, torch.Tensor) or amount:
        obs["ctr"][slot:slot + 1].add_(amount)
    return obs


def iter_tick(obs: Dict, n_iter, branch, live_cnt, drafted_d, accepted_d,
              free_blocks, tok=None, stall=None) -> Dict:
    """The shared per-iteration sample, in place: one ring row at index
    ``n_iter`` (saturating) plus the token, stall and free-list counters.
    ``tok``, the tokens the branch emitted, defaults to
    ``obs['tick_tok']``.  Values may be ints or device tensors (a
    captured step computes them; pass int32 tensors, and ints from
    ``consts``, to launch no conversion).  ``stall`` (the iteration's
    stall, 0 or 1) is derived from the live count and ``tok`` unless the
    caller knows it; ``free_blocks`` None (a contiguous pool) leaves the
    free-list low-water mark alone and samples 0."""
    it, ctr, dev = obs["it"], obs["ctr"], obs["it"].device
    cap = it.shape[0] - 1
    tok = obs["tick_tok"] if tok is None else tok
    free = 0 if free_blocks is None else free_blocks
    row = torch.stack([_i32(v, dev) for v in
                       (branch, live_cnt, tok, drafted_d, accepted_d, free)])
    if isinstance(n_iter, torch.Tensor):
        it.index_copy_(0, torch.clamp(n_iter, max=cap).reshape(1).long(),
                       row.reshape(1, _IT_COLS))
    else:
        it[min(int(n_iter), cap)].copy_(row)
    if stall is None:
        stall = ((_i32(live_cnt, dev) > 0) & (_i32(tok, dev) == 0)
                 ).to(torch.int32)
    if isinstance(stall, torch.Tensor):
        ctr[CTR_TOKENS:CTR_STALL + 1].add_(
            torch.stack([_i32(tok, dev), stall]))
    else:
        ctr_add(obs, CTR_TOKENS, tok)
        ctr_add(obs, CTR_STALL, stall)
    if free_blocks is not None:
        torch.minimum(ctr[CTR_MIN_FREE], _i32(free_blocks, dev),
                      out=ctr[CTR_MIN_FREE])
    return obs


class EagerRecords:
    """The ring records of the iterations the host runs eagerly, kept on
    the host (module docstring) and written into the device rings after
    the loop by ``apply``: ``push`` an event, ``tick`` a sample row (its
    free count later by ``set_free`` where the branch cannot know it),
    ``add`` to a counter -- the arithmetic of ``ring_push``,
    ``iter_tick`` and ``ctr_add``."""

    def __init__(self):
        self.events: List[tuple] = []
        self.rows: Dict[int, List[int]] = {}
        self.ctr = [0] * N_CTR
        self.min_free = int(_I32_MAX)
        self._free_due: List[int] = []

    def push(self, kind: int, rid: int, it: int) -> None:
        self.events.append((kind, int(rid), int(it)))

    def add(self, slot: int, amount: int) -> None:
        self.ctr[slot] += int(amount)

    def tick(self, n_iter: int, branch: int, live_cnt: int, tok: int,
             drafted_d: int = 0, accepted_d: int = 0,
             free_blocks: Optional[int] = -1) -> None:
        """A sample row; ``free_blocks`` None: due at the next
        ``set_free``; -1: a contiguous pool (sampled 0, no low-water
        mark)."""
        self.rows[int(n_iter)] = [branch, live_cnt, tok, drafted_d,
                                  accepted_d, 0]
        self.ctr[CTR_TOKENS] += tok
        self.ctr[CTR_STALL] += int(live_cnt > 0 and tok == 0)
        if free_blocks is None:
            self._free_due.append(int(n_iter))
        elif free_blocks >= 0:
            self.set_free(free_blocks, [int(n_iter)])

    def set_free(self, free_blocks: int, iters=None) -> None:
        """The free count after the rows still waiting for one."""
        for n in (self._free_due if iters is None else iters):
            self.rows[n][IT_FREE] = int(free_blocks)
            self.min_free = min(self.min_free, int(free_blocks))
        if iters is None:
            self._free_due = []

    def apply(self, obs: Dict) -> None:
        """Write the records into ``obs`` (whose event cursor is 0: every
        event is an eager branch's) in one copy to the device: the events
        from row 0, the sample rows at their iterations (saturating into
        the sink row), the counter deltas and the low-water mark."""
        ev, it, ctr = obs["ev"], obs["it"], obs["ctr"]
        ev_cap, it_cap = ev.shape[0] - 1, it.shape[0] - 1
        n_ev = len(self.events)
        k = min(n_ev, ev_cap)
        idx = sorted(self.rows)
        buf = np.asarray(
            [c for e in self.events[:k] for c in e]
            + [min(n, it_cap) for n in idx]
            + [c for n in idx for c in self.rows[n]]
            + self.ctr + [self.min_free, n_ev], np.int64)
        t = torch.from_numpy(buf).to(ev.device)
        o = 3 * k
        if k:
            ev[:k].copy_(t[:o].view(k, 3))
        if idx:
            n = len(idx)
            it.index_copy_(0, t[o:o + n], t[o + n:o + n * (1 + _IT_COLS)]
                           .view(n, _IT_COLS).to(torch.int32))
            o += n * (1 + _IT_COLS)
        ctr.add_(t[o:o + N_CTR].to(torch.int32))
        torch.minimum(ctr[CTR_MIN_FREE], t[o + N_CTR].to(torch.int32),
                      out=ctr[CTR_MIN_FREE])
        obs["ev_n"].add_(t[o + N_CTR + 1].to(torch.int32))


def obs_to_host(obs: Dict) -> Dict[str, np.ndarray]:
    """The rings as numpy arrays, read in ONE device-to-host transfer
    (every leaf flattened into one int32 vector)."""
    names = [n for n, _, _ in _LEAVES if n in obs]
    flat = torch.cat([obs[n].reshape(-1) for n in names]).cpu().numpy()
    out, o = {}, 0
    for n in names:
        k = obs[n].numel()
        out[n] = flat[o:o + k].reshape(tuple(obs[n].shape))
        o += k
    return out


# -- host-side harvest ------------------------------------------------------


@dataclasses.dataclass
class ObsSnapshot:
    """Typed view of one workload's harvested rings."""
    n_iter: int
    wall_s: float
    slots: int
    iter_s_est: float                 # wall-clock calibration: wall/n_iter
    counters: Dict[str, int]
    events: List[Dict]                # [{kind, rid, iter}], recorded rows
    dropped_events: int
    recorded_iters: int               # iter-ring rows actually captured
    spans: List[Dict]                 # per-request admit/first/finish spans
    ttft_iters: Dict[int, int]        # rid -> first-token iteration
    occupancy_mean: float
    stall_factor_iters: float
    acceptance_rate: float
    min_free_blocks: Optional[int]
    iter_samples: Dict[str, np.ndarray]

    def ttft_percentiles_iters(self) -> Dict[str, float]:
        ts = sorted(self.ttft_iters.values())
        if not ts:
            return {"ttft_p50_iters": float("nan"),
                    "ttft_p95_iters": float("nan")}
        pick = lambda q: ts[min(len(ts) - 1, int(q * (len(ts) - 1) + 0.5))]
        return {"ttft_p50_iters": float(pick(0.50)),
                "ttft_p95_iters": float(pick(0.95))}

    def ttft_percentiles_s(self) -> Dict[str, float]:
        it = self.ttft_percentiles_iters()
        return {"ttft_p50_s": it["ttft_p50_iters"] * self.iter_s_est,
                "ttft_p95_s": it["ttft_p95_iters"] * self.iter_s_est}

    def to_dict(self) -> Dict:
        # every possibly-undefined statistic follows one convention: NaN
        # (zero-token / zero-iteration workloads) serializes as None, so
        # the snapshot is always valid JSON (NaN is not)
        opt = lambda v, nd: round(v, nd) if v == v else None
        d = dict(n_iter=self.n_iter, wall_s=round(self.wall_s, 4),
                 iter_s_est=self.iter_s_est, slots=self.slots,
                 counters=self.counters,
                 dropped_events=self.dropped_events,
                 recorded_iters=self.recorded_iters,
                 occupancy_mean=opt(self.occupancy_mean, 4),
                 stall_factor_iters=opt(self.stall_factor_iters, 4),
                 acceptance_rate=opt(self.acceptance_rate, 4),
                 min_free_blocks=self.min_free_blocks,
                 spans=self.spans,
                 **{k: round(v, 2) if v == v else None
                    for k, v in self.ttft_percentiles_iters().items()},
                 **{k: round(v, 6) if v == v else None
                    for k, v in self.ttft_percentiles_s().items()})
        return d

    def register(self, registry, prefix: str = "serve") -> None:
        """Publish this snapshot into a metrics registry."""
        c = self.counters
        registry.counter(f"{prefix}_tokens_total",
                         "tokens emitted by the device loop").inc(
            c["tokens"])
        registry.counter(f"{prefix}_stall_iters_total",
                         "iterations with live decoders but no tokens"
                         ).inc(c["stall_iters"])
        registry.counter(f"{prefix}_adc_clip_total",
                         "ADC codes clipped in the packed GEMM path").inc(
            c["adc_clip"])
        registry.counter(f"{prefix}_prefix_blocks_total",
                         "shared-prefix KV blocks reused").inc(
            c["prefix_blocks"])
        registry.counter(f"{prefix}_events_dropped_total",
                         "event-ring rows dropped after saturation").inc(
            self.dropped_events)
        # gauges that are undefined (NaN) for an empty workload -- zero
        # recorded iterations or zero decode steps -- are skipped rather
        # than published (a NaN gauge is noise to every scraper)
        if self.occupancy_mean == self.occupancy_mean:
            registry.gauge(f"{prefix}_occupancy",
                           "mean live-slot fraction over sampled iterations"
                           ).set(self.occupancy_mean)
        if self.stall_factor_iters == self.stall_factor_iters:
            registry.gauge(f"{prefix}_stall_factor_iters",
                           "decode-timeline inflation by non-emitting "
                           "iterations").set(self.stall_factor_iters)
        if self.min_free_blocks is not None:
            registry.gauge(f"{prefix}_free_blocks_min",
                           "paged free-list low-water mark").set(
                self.min_free_blocks)
        if self.acceptance_rate == self.acceptance_rate:
            registry.gauge(f"{prefix}_acceptance_rate",
                           "draft tokens accepted / drafted").set(
                self.acceptance_rate)
        h = registry.histogram(
            f"{prefix}_ttft_seconds", "time to first token (calibrated "
            "from iteration stamps)",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0))
        h.observe_many([t * self.iter_s_est
                        for t in self.ttft_iters.values()])


def harvest_obs(cfg: ObsConfig, raw: Dict, *, n_iter: int, wall_s: float,
                slots: int, n_steps: int, n_drafted: int = 0,
                n_accepted: int = 0, paged: bool = False) -> ObsSnapshot:
    """Convert the rings into a typed snapshot.

    ``raw`` is the device dict (read here in one transfer,
    ``obs_to_host``) or its numpy mirror; the sink rows past each ring's
    capacity are never read."""
    if any(isinstance(v, torch.Tensor) for v in raw.values()):
        raw = obs_to_host(raw)
    ev = np.asarray(raw["ev"])
    ev_n = int(raw["ev_n"])
    it = np.asarray(raw["it"])
    ctr = np.asarray(raw["ctr"])
    n_rec = min(ev_n, cfg.event_cap)
    events = [dict(kind=EV_NAMES.get(int(k), str(int(k))), rid=int(r),
                   iter=int(i)) for k, r, i in ev[:n_rec]]
    rec_it = min(int(n_iter), cfg.iter_cap)
    samples = {name: it[:rec_it, col].copy() for name, col in
               (("branch", IT_BRANCH), ("live", IT_LIVE), ("tok", IT_TOK),
                ("drafted", IT_DRAFTED), ("accepted", IT_ACCEPTED),
                ("free", IT_FREE))}

    by_rid: Dict[int, Dict] = {}
    for e in events:
        by_rid.setdefault(e["rid"], {})[e["kind"]] = e["iter"]
    iter_s = wall_s / max(int(n_iter), 1)
    spans = []
    for rid in sorted(by_rid):
        s = by_rid[rid]
        rec = dict(rid=rid, admit_iter=s.get("admit"),
                   first_iter=s.get("first_token"),
                   finish_iter=s.get("finish"))
        if rec["first_iter"] is not None:
            rec["ttft_s_est"] = round(rec["first_iter"] * iter_s, 6)
        if rec["admit_iter"] is not None and rec["finish_iter"] is not None:
            rec["span_iters"] = rec["finish_iter"] - rec["admit_iter"]
        spans.append(rec)
    ttft = {r["rid"]: r["first_iter"] for r in spans
            if r["first_iter"] is not None}

    live = samples["live"]
    occ = float(np.mean(live) / max(slots, 1)) if rec_it else float("nan")
    stalls = int(ctr[CTR_STALL])
    stall_factor = ((n_steps + stalls) / n_steps if n_steps
                    else float("nan"))
    acc = n_accepted / n_drafted if n_drafted else float("nan")
    min_free = int(ctr[CTR_MIN_FREE])
    counters = dict(tokens=int(ctr[CTR_TOKENS]), stall_iters=stalls,
                    adc_clip=int(ctr[CTR_ADC_CLIP]),
                    prefix_blocks=int(ctr[CTR_PREFIX_BLOCKS]),
                    shared_admits=int(ctr[CTR_SHARED_ADMITS]))
    return ObsSnapshot(
        n_iter=int(n_iter), wall_s=float(wall_s), slots=slots,
        iter_s_est=iter_s, counters=counters, events=events,
        dropped_events=max(ev_n - cfg.event_cap, 0),
        recorded_iters=rec_it, spans=spans, ttft_iters=ttft,
        occupancy_mean=occ, stall_factor_iters=stall_factor,
        acceptance_rate=acc,
        min_free_blocks=(None if (not paged or min_free == int(_I32_MAX))
                         else min_free),
        iter_samples=samples)
