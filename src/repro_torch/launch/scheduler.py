"""Continuous-batching serving scheduler over a fixed pool of decode slots.

Counterpart of ``repro/launch/scheduler.py``.  The paper's macro is weight-stationary: weights are
written once and activations stream.  The serving analogue is a fixed
pool of decode slots over prepacked weights; every pooled step advances
only live slots, and a freed slot is refilled from the request queue.
Each iteration runs one branch, in this priority:

  harvest : some slot finished (stop token or max-new-tokens, parked in
            the ``pending`` mask) -> copy its output row into the
            per-request results and free the slot (paged mode: one ref
            off each block of its grant, its table back to the trash
            block).
  admit   : a slot is free and the queue head is admissible -> contiguous
            mode prefills the whole prompt (``lm.prefill_into_slot``) and
            samples the first token; paged mode only ALLOCATES (blocks off
            the refcount free list, the shared-prefix chain copied from the
            donor's recorded table, pin refcounts placed) and marks the
            slot ``filling``.
  prefill : (paged only; when no slot is live, or the last branch was not
            a prefill) advance the first filling slot by one
            ``prefill_chunk`` (``lm.prefill_chunk_into_slot``); the final
            chunk samples the request's first token.
  step    : one pooled decode step (``lm.decode_step`` with ``live``), or
            with ``draft_k`` one speculative round (``_spec_step``).

The reference runs this loop on the device in one compiled
``while_loop``.  Here the HOST runs it: the pool state (tokens, masks,
KV cache, block refcounts) lives on the device, and each iteration reads
one small int32 vector back -- the pending and live masks, the free
block count and, in speculative mode, the draft counters and the next
round's draft depth -- to pick its branch.  That is ONE host
synchronization per iteration; everything else the branch choice needs
(queue head, filling slots, prefill progress, grants) the host already
knows.  Slots are
Python ints and per-slot scalars are written with fills, so the loop
makes no host-to-device copy (a pageable one would synchronize the
stream).

The step branch is what the reference's host-stepped runner compiles
on its own (one iteration around ``_step_once``).  On a CUDA device the
pooled step, and each rung's speculative round, is a CUDA graph
captured at its first call and replayed after (``launch/graphs.py``;
``graphs=False`` runs it eagerly, as the CPU does).  The step bodies
write every entry of the state they change into the tensor that holds
it, so the flags read sees what a replay wrote; harvest and admit pick
Python-int slots and stay eager.  The paged prefill chunk's forward is
one graph per slot (``_prefill_chunk``): every chunk of a slot has the
same shapes and starts at the slot's device position, so only its
tokens change, copied into a static buffer before the replay; the first
token is sampled eagerly from the replay's logits.  The pool state
lives on the scheduler and each run resets it in place, so the graphs
outlive a run.

PAGED mode (``paged=PagedLayout(...)``) replaces the per-slot contiguous
``max_seq`` regions with global per-layer block pools and per-slot block
tables.  A ``(n_blocks,)`` refcount vector on the device doubles as the
free list (free <=> ref == 0; block 0 is the trash block, pinned at 1);
admission grants ``max_blk`` blocks as ``argsort(free-first, by id)``, so
block ids and ``peak_blocks`` come out as the reference's; harvest
decrements.  Shared prompt prefixes are planned on the host
(paging.plan_prefix_sharing), and the refcounts return to ``[1, 0, ...]``
when the queue drains.  The ssm and hybrid families keep their SSM and
conv state per slot, dense (the hybrid's shared-block KV is paged like
any KV), and follow the reference's rules: a paged prompt is a
whole number of prefill chunks (a padded chunk tail would run through
the recurrent state), no prefix is shared, and no speculative round
runs (the state cannot roll back a rejected draft).

SPECULATIVE mode (``draft_k > 0``) turns each step branch into one
plan-cascade round: ``draft_k`` pooled decode steps under ``draft_cfg``
(the all-analog shadow plan, same pack), the positions rolled back, one
``lm.verify_step`` over the k+1 positions under the deployed config,
then the longest agreeing prefix plus a correction, clamped by each
request's budget and cut after a stop token.  Rollback is positional:
rows past the committed ``pos`` are masked and overwritten by the next
round, and paged tables are not touched mid-round (admission grants
``draft_k`` rows of headroom); non-live rows' draft and verify writes go
to the trash block.  ``adaptive_draft_k`` picks each round's depth from
the rung ladder {K, K/2, K/4} by an acceptance EMA kept on the device.

Determinism contract: a request's tokens depend only on (params, prompt,
rid) -- not on its slot, its poolmates or when it was admitted -- and
greedy speculative tokens equal non-speculative ones.  At temperature >
0 each request samples from its own stream, ``fold_in(sampling_key(seed),
rid)`` (``core/prng.py``, the reference's threefry bit for bit), split
once at its first token and once per pooled step, and each slot's key
is state the captured step updates on the device; so sampled pool
tokens equal solo runs too, and speculative rounds (rejection sampling)
equal speculative solo runs at the same ``draft_k``.  Analog noise
(``cfg.cim_noise_seed``) is drawn per pool row, so noisy tokens depend
on the slot a request ran in -- as on silicon, where each slot maps to
a physical macro bank -- and the slot-independence contract holds only
noise-free.

Open-loop arrivals: ``run(requests, arrival_iters)`` admits request i
no earlier than loop iteration ``arrival_iters[i]`` (the device clock
is the iteration count); while nothing is due the loop steps the pool,
as the reference's does, so iteration stamps equal the reference's.
``run_instrumented`` returns the same report with the per-iteration
timeline (each iteration's branch and seconds): the loop reads the host
clock at every flags read anyway, so it is the same program as ``run``,
and both fill each request's ``ttft_s``.

Telemetry (``obs=ObsConfig(...)``, ``obs/rings.py``): fixed-size int32
rings beside the pool state record each request's admit, first-token
and finish iterations (at the sites that set ``res_first`` and
``res_iter``), one sample row per iteration and scalar counters --
tokens, stall iterations, ADC clips, shared-prefix blocks and admits,
the free-list low-water mark.  The pooled step and the speculative
rounds write their sample rows and counters on the device inside their
bodies, so their captured graphs carry them (a metrics-on scheduler
captures its own graphs); harvest, admit and the prefill chunk, whose
every value the host decides, keep their events and rows on the host
(``obs_rings.EagerRecords``) and write them into the device rings in one
batch after the loop, so an eager iteration launches nothing more.  The ADC clips come through ``obs/taps.py``: one collector
frame over the run, whose buffer is the rings' ``CTR_ADC_CLIP`` slot,
into which kernel rows 1 and 2 (and the plain version on the CPU) add
directly.  The rings only read values the loop already computes, so the
tokens are equal with metrics on and off, and the loop reads the device
no more often (``host_syncs == n_iter + 1``); ``harvest_obs`` reads them
in one transfer after the loop.

Segments and faults (``resilience/failover.py``).  A run is ``_begin``
(the staged workload, the reset state, the host mirrors), ``_iterate``
and ``_finish``; ``_iterate(lp, budget)`` stops once the loop's
iteration count reaches ``budget`` and the next call resumes exactly
there, in this scheduler or in a sibling that runs on the same pool
state (``share_state``): the guarded server's segments, its rung
switches, and ``capture_graphs``, which captures every graph before a
run.  Under an armed fault model (``resilience/faults.py``) each
iteration writes its index into the state's device clock
``fault_clock`` before its branch, and the GEMMs read the drift there,
captured steps included; with none armed the loop runs not one op more.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import prng
from ..models import lm
from ..models.config import ModelConfig
from ..obs import rings as obs_rings
from ..obs import taps
from ..obs.rings import ObsConfig, ObsSnapshot
from ..resilience import faults
from .graphs import StepGraph, use_graphs
from .paging import PagedLayout, cdiv, contiguous_kv_bytes, plan_prefix_sharing

BRANCHES = ("harvest", "admit", "prefill", "step")


def sampling_key(seed: int, device=None) -> torch.Tensor:
    """The sampling stream of ``seed``, distinct from the params-init
    stream: ``fold_in(PRNGKey(seed), "SAMP")``, the reference's."""
    return prng.fold_in(prng.PRNGKey(seed, device), 0x53414D50)


def _inverse(temperature: float) -> float:
    """float32 1/T: the reference's compiled steps scale logits by it
    (XLA turns a division by a constant into this multiply)."""
    return float(np.float32(1.0) / np.float32(temperature))


def sample_rows(logits: torch.Tensor, keys: Optional[torch.Tensor],
                temperature: float) -> torch.Tensor:
    """One token per row of ``logits`` (R, V): the argmax at temperature
    0, else a categorical draw of the logits times float32(1/T), as the
    reference's compiled scheduler and speculative round sample: from row
    r's own key ``keys[r]`` ((R, 2) keys), or from one key (2,) over the
    whole batch.  int64 (R,)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    return prng.categorical(keys, logits * _inverse(temperature))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def rejection_accept(drafts: torch.Tensor, d_logits: torch.Tensor,
                     vlogits: torch.Tensor, u: torch.Tensor,
                     temperature: float):
    """Speculative sampling's accept rule at temperature T: drafts (B,
    K) drawn from the draft logits (B, K, V), the verify logits (B, K+1,
    V) and uniforms u (B, K) -> (n_acc (B,), residual log-weights (B,
    V)).  Draft i is kept while u_i p_d(d_i) < p_v(d_i); at the first
    rejection the correction is drawn from max(p_v - p_d, 0), normalized
    (p_v where that sums to 0), and after a fully accepted block from
    p_v at position K: the caller draws it with ``prng.categorical`` of
    the returned log(max(res, 1e-38)).  The reference's operations in
    its order (``launch/scheduler.py::spec_step``)."""
    K = drafts.shape[1]
    inv = _inverse(temperature)
    p_d = _softmax(d_logits * inv)
    p_v = _softmax(vlogits * inv)
    idx = drafts[..., None]
    pd_tok = torch.gather(p_d, -1, idx)[..., 0]
    pv_tok = torch.gather(p_v[:, :K], -1, idx)[..., 0]
    acc = (u * pd_tok < pv_tok).to(torch.int32)
    n_acc = torch.cumprod(acc, dim=1).sum(dim=1)
    rows = torch.arange(drafts.shape[0], device=drafts.device)
    pv_n = p_v[rows, n_acc]
    pd_n = torch.cat([p_d, torch.zeros_like(p_d[:, :1])], dim=1)[rows, n_acc]
    res = torch.clamp_min(pv_n - pd_n, 0.0)
    tot = res.sum(dim=-1, keepdim=True)
    res = torch.where(tot > 0, res / torch.clamp_min(tot, 1e-38), pv_n)
    return n_acc, prng.log(torch.clamp_min(res, 1e-38))


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``rid`` must be unique within a run.
    ``stop_token < 0`` disables stop detection (the request runs to
    ``max_new_tokens``)."""
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    stop_token: int = -1


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    tokens: np.ndarray            # (n,) generated tokens, stop token incl.
    latency_s: float              # run start -> end of its harvest iteration
    finish_iter: int              # loop iteration the request finished at
    first_iter: int = 0           # loop iteration its first token appeared
    ttft_s: float = float("nan")  # run start -> end of its first-token
                                  # iteration


@dataclasses.dataclass
class ServeReport:
    finished: List[FinishedRequest]
    wall_s: float
    n_steps: int                  # pooled decode steps
    n_admits: int
    slots: int
    n_pf: int = 0                 # chunked-prefill iterations (paged mode)
    peak_blocks: int = 0          # peak live pool blocks (paged mode)
    n_iter: int = 0               # loop iterations
    n_drafted: int = 0            # draft tokens proposed (speculative mode)
    n_accepted: int = 0           # draft tokens accepted by verify
    draft_steps: int = 0          # pooled draft decode steps (speculative)
    host_syncs: int = 0           # device-to-host reads in the loop
                                  # (one per iteration + the last)
    branch_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    branch_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    ref_final: Optional[np.ndarray] = None   # block refcounts after drain
    obs: Optional[ObsSnapshot] = None        # harvested rings (obs mode)

    @property
    def total_tokens(self) -> int:
        return sum(len(f.tokens) for f in self.finished)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verify pass accepted."""
        return (self.n_accepted / self.n_drafted if self.n_drafted
                else float("nan"))

    @property
    def tokens_per_step(self) -> float:
        """Emitted tokens per pooled step (a round, in speculative mode)."""
        return (self.total_tokens / self.n_steps if self.n_steps
                else float("nan"))

    @property
    def tok_s(self) -> float:
        return (self.total_tokens / self.wall_s if self.wall_s > 0
                else float("nan"))

    @property
    def occupancy(self) -> float:
        """Useful-token fraction of the slot-steps spent (admits each
        yield one token; every pooled step spends ``slots`` slot-steps)."""
        slot_steps = self.slots * self.n_steps + self.n_admits + self.n_pf
        return self.total_tokens / slot_steps if slot_steps else float("nan")

    def latency_percentiles(self) -> Dict[str, float]:
        lats = sorted(f.latency_s for f in self.finished)
        if not lats:
            return {"p50_s": float("nan"), "p95_s": float("nan")}
        pick = lambda q: lats[min(len(lats) - 1,
                                  int(q * (len(lats) - 1) + 0.5))]
        return {"p50_s": pick(0.50), "p95_s": pick(0.95)}

    def ttft_percentiles(self) -> Dict[str, float]:
        """Time-to-first-token percentiles over the requests whose
        ``ttft_s`` was measured (NaN when none was)."""
        ts = sorted(f.ttft_s for f in self.finished
                    if not np.isnan(f.ttft_s))
        if not ts:
            return {"ttft_p50_s": float("nan"), "ttft_p95_s": float("nan")}
        pick = lambda q: ts[min(len(ts) - 1, int(q * (len(ts) - 1) + 0.5))]
        return {"ttft_p50_s": pick(0.50), "ttft_p95_s": pick(0.95)}

    def summary(self) -> Dict:
        out = dict(total_tokens=self.total_tokens,
                   wall_s=round(self.wall_s, 4),
                   tok_s=round(self.tok_s, 2),
                   occupancy=round(self.occupancy, 4),
                   n_steps=self.n_steps, n_admits=self.n_admits,
                   slots=self.slots,
                   **{k: round(v, 4) for k, v in
                      self.latency_percentiles().items()})
        if self.n_drafted:
            out.update(n_drafted=self.n_drafted,
                       n_accepted=self.n_accepted,
                       acceptance_rate=round(self.acceptance_rate, 4),
                       tokens_per_step=round(self.tokens_per_step, 4))
        if self.n_pf or self.peak_blocks:
            out.update(n_pf=self.n_pf, peak_blocks=self.peak_blocks)
        return out

    def tokens_by_rid(self) -> Dict[int, np.ndarray]:
        return {f.rid: f.tokens for f in self.finished}


class _Loop:
    """The host side of one run in progress: the staged workload, the
    pool state it runs on, the per-request result buffers, and the host
    mirrors of what the host decides (slot occupants, filling slots and
    their chunk starts, the queue head, the iteration count, the branch
    record).  A run stopped at a segment boundary resumes from it."""

    def __init__(self):
        self.done = False
        self.q_head = self.n_iter = self.syncs = self.draft_steps = 0
        self.clock = 0                  # the iteration the obs clock holds
        self.last_pf = False
        self.flags = None               # the last flags read
        self.iter_end: List[float] = []  # run clock at each flags read
        self.branches: List[str] = []


class ContinuousBatchingScheduler:
    """Fixed-slot continuous batching, greedy or sampled.

    ``params`` may hold prepacked CIM weights (lm.pack_cim_params); the
    scheduler never touches weights.  ``max_new_cap`` bounds every
    request's max_new_tokens and sizes the output buffers;
    ``prompt_len`` is the MAXIMUM prompt length (contiguous mode: the
    exact length; paged mode: shorter prompts are fine).

    ``paged=PagedLayout(...)`` switches the KV cache to the global block
    pool with on-device refcounts, host-planned shared-prefix reuse
    (``prefix_sharing``) and chunked prefill (``prefill_chunk`` tokens
    per iteration, default: the whole prompt in one chunk).
    ``draft_k > 0`` turns the step branch into a speculative round
    drafting under ``draft_plan`` (default: the deployed config itself);
    ``adaptive_draft_k`` switches the round's depth over {K, K/2, K/4} by
    the acceptance EMA.  ``graphs`` (default: on a CUDA device) replays
    the step branch from captured graphs, one for the pooled step and one
    per rung; ``True`` off CUDA raises.  The device is the params'
    device.  ``temperature`` > 0 samples every token from the request's
    stream under ``sampling_key(seed)`` (greedy at 0).  ``obs`` (an
    ``obs.ObsConfig``) keeps the telemetry rings (module docstring) and
    fills ``ServeReport.obs``."""

    def __init__(self, params, cfg: ModelConfig, slots: int, prompt_len: int,
                 max_new_cap: int, temperature: float = 0.0, seed: int = 0,
                 pad_token: int = 0, draft_k: int = 0, draft_plan=None,
                 paged: Optional[PagedLayout] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_sharing: bool = True,
                 adaptive_draft_k: bool = False,
                 obs: Optional[ObsConfig] = None,
                 graphs: Optional[bool] = None):
        lm.check_family(cfg)
        if cfg.family == "vlm":
            raise NotImplementedError(
                "scheduler is text-only for now (no per-request frontends)")
        if draft_k:
            lm.check_speculative(cfg)
        if draft_k < 0 or draft_k > 31:
            raise ValueError(f"draft_k {draft_k} outside [0, 31] (k+1 must "
                             "stay on the skinny-M verify path)")
        if adaptive_draft_k and not draft_k:
            raise ValueError("adaptive_draft_k needs draft_k > 0")
        self.cfg, self.slots = cfg, slots
        self.obs = obs
        self.prompt_len, self.cap = prompt_len, max_new_cap
        self.temperature, self.pad_token = temperature, pad_token
        self.draft_k = draft_k
        rungs: List[int] = []
        for k in (draft_k, draft_k // 2, draft_k // 4):
            k = max(1, k)
            if k not in rungs:
                rungs.append(k)
        self._rungs = rungs if adaptive_draft_k else [draft_k]
        self.draft_cfg = (dataclasses.replace(cfg, cim_plan=draft_plan)
                          if draft_plan is not None else cfg)
        # speculative rounds write draft and verify KV rows up to
        # pos + draft_k before rolling back: that much headroom
        self.max_seq = prompt_len + max_new_cap + draft_k
        self._params = params
        self.device = _params_device(params)
        self._base_key = sampling_key(seed, self.device)
        self.graphs = use_graphs(graphs, self.device)
        self._st: Optional[Dict] = None         # the pool state, see _state
        self._graphs: Dict[int, StepGraph] = {}  # 0: the step; K: a round
        self._chunk_graphs: Dict[int, StepGraph] = {}   # slot -> its chunk
        self._graph_fault = None   # the fault model the graphs hold
        self.paged = paged
        self.prefix_sharing = prefix_sharing
        if paged is not None:
            C = prefill_chunk if prefill_chunk is not None else prompt_len
            if not (1 <= C <= prompt_len):
                raise ValueError(f"prefill_chunk {C} outside [1, {prompt_len}]")
            if paged.n_tbl >= paged.n_blocks:
                raise ValueError(
                    f"table width {paged.n_tbl} >= pool size {paged.n_blocks}"
                    " (one slot could hold more blocks than exist)")
            self.prefill_chunk = C
            self._p_pad = cdiv(prompt_len, C) * C
            need = max(self._p_pad, prompt_len + max_new_cap - 1 + draft_k)
            if paged.tokens_per_slot < need:
                raise ValueError(
                    f"paged layout addresses {paged.tokens_per_slot} tokens "
                    f"per slot < worst-case need {need} (prompt span + "
                    "decode budget + draft headroom)")
        else:
            self.prefill_chunk = prompt_len
            self._p_pad = prompt_len
        self.last_prefix_plan = None
        # the reference's branch indices: its lax.switch order
        self._branch_code = dict(harvest=0, admit=1, prefill=2,
                                 step=3 if paged is not None else 2)

    # -- KV footprint accounting ---------------------------------------

    def kv_bytes_contiguous(self, dtype_bytes: int = 2) -> int:
        """KV bytes the contiguous layout holds for this pool (slots *
        max_seq regions): the baseline of the paged peak."""
        return contiguous_kv_bytes(self.cfg, self.slots, self.max_seq,
                                   dtype_bytes=dtype_bytes)

    def kv_bytes_paged(self, n_blocks: Optional[int] = None,
                       dtype_bytes: int = 2) -> int:
        """KV bytes of ``n_blocks`` pool blocks (default: the pool)."""
        if self.paged is None:
            raise ValueError("kv_bytes_paged on a contiguous scheduler")
        return self.paged.kv_bytes(self.cfg, n_blocks=n_blocks,
                                   dtype_bytes=dtype_bytes)

    # -- pool state ----------------------------------------------------

    def graph_stats(self) -> Dict[str, Dict]:
        """Per captured body (``step``, ``round_k<K>``, or a slot's
        prefill chunk, ``chunk_slot<s>``): capture seconds, pool bytes,
        replays and kernel launches per replay."""
        named = [("step" if k == 0 else f"round_k{k}", g)
                 for k, g in self._graphs.items()]
        named += [(f"chunk_slot{s}", g)
                  for s, g in self._chunk_graphs.items()]
        return {name: dict(capture_s=g.capture_s, pool_bytes=g.pool_bytes,
                           replays=g.replays, launches_per_replay=g.launches)
                for name, g in named if g.graph is not None}

    def _advance(self, st: Dict, K: int = 0) -> None:
        """The step branch: a pooled decode step (K == 0) or a
        speculative round of K drafts, replayed from its graph when the
        scheduler captures."""
        if not self.graphs:
            if K:
                self._spec_step(st, K)
            else:
                self._step(st)
            return
        self._check_graph_fault()
        if K not in self._graphs:
            # the graph holds its body, which must not hold the scheduler:
            # a cycle would keep the packed weights, the KV cache and the
            # graph's pool alive until the next garbage collection
            me = weakref.ref(self)
            body = ((lambda: me()._step(st)) if K == 0
                    else (lambda: me()._spec_step(st, K)))
            self._graphs[K] = StepGraph(body, self.device)
        self._graphs[K]()

    def _prefill_chunk(self, st: Dict, slot: int, toks: torch.Tensor
                       ) -> torch.Tensor:
        """The prefill branch's forward: ``lm.prefill_chunk_into_slot`` of
        ``slot`` on the chunk's tokens (1, C), which starts at the slot's
        device position; returns the chunk's logits (1, C, V).  When the
        scheduler captures, each slot's chunk is one graph (its tokens
        copied into a static buffer first), replayed for every later chunk
        of that slot; its shapes are the same for every chunk."""
        if not self.graphs:
            logits, st["cache"] = lm.prefill_chunk_into_slot(
                self._params, self.cfg, toks, st["cache"], slot)
            return logits
        self._check_graph_fault()
        buf = st["chunk_tok"]
        buf.copy_(toks)
        if slot not in self._chunk_graphs:
            me, cache = weakref.ref(self), st["cache"]
            self._chunk_graphs[slot] = StepGraph(
                lambda: lm.prefill_chunk_into_slot(
                    me()._params, me().cfg, buf, cache, slot)[0],
                self.device)
        return self._chunk_graphs[slot]()

    def _check_graph_fault(self) -> None:
        """A captured graph holds the fault epilogue armed at its capture
        (``resilience/faults.py``), or none: replaying it under another
        arming would silently serve the other macro, so that raises."""
        armed = faults.site().model if faults.active() else None
        if not (self._graphs or self._chunk_graphs):
            self._graph_fault = armed
        elif armed != self._graph_fault:
            raise RuntimeError(
                f"this scheduler's graphs were captured under fault model "
                f"{self._graph_fault}, not {armed}: serve an armed model "
                "from a scheduler of its own")

    def capture_graphs(self) -> int:
        """Capture, before any run, every graph a run replays: the pooled
        step or each rung's speculative round, and (paged) each slot's
        prefill chunk, under the fault model armed now (if any) and the
        telemetry collector.  A graph's first call is one real eager step
        on the pool state, which is empty here; the state is then reset
        to its start-of-run values, as every run resets it, so nothing
        of the warm-up reaches a run.  Returns the number of graphs
        captured (0 when the scheduler does not capture)."""
        if not self.graphs:
            return 0
        before = len(self._graphs) + len(self._chunk_graphs)
        st = self._state()
        with torch.inference_mode(), self._collector(st):
            fclock = self._fault_clock(st)
            with (faults.clock(fclock) if fclock is not None
                  else contextlib.nullcontext()):
                for K in (self._rungs if self.draft_k else [0]):
                    if K not in self._graphs:
                        self._advance(st, K)
                if self.paged is not None:
                    toks = torch.full((1, self.prefill_chunk),
                                      self.pad_token, dtype=torch.int64,
                                      device=self.device)
                    for slot in range(self.slots):
                        if slot not in self._chunk_graphs:
                            self._prefill_chunk(st, slot, toks)
        self._state()
        return len(self._graphs) + len(self._chunk_graphs) - before

    def share_state(self, other: "ContinuousBatchingScheduler") -> None:
        """Run on ``other``'s pool state from now on: a sibling scheduler
        (same params, slot geometry, telemetry and sampling, a
        pack-compatible plan) whose runs and segments this scheduler can
        continue.  Its graphs, captured on that state, stay its own."""
        if self._graphs or self._chunk_graphs:
            raise RuntimeError("share_state after a capture: the graphs "
                               "hold the old state")
        same = lambda a: (a.slots, a.cap, a.prompt_len, a.max_seq, a.paged,
                          a.prefill_chunk, a.obs, a.temperature,
                          a.pad_token, a.draft_k, a.device)
        if same(self) != same(other):
            raise ValueError("share_state needs the same slot geometry, "
                             "telemetry, sampling and device")
        other._state()
        self._st = other._st

    def _state(self) -> Dict:
        """The pool state at the start of a run.  Its tensors are made by
        the first run and reset in place by later ones: the captured step
        graphs read and write these very tensors."""
        B, cap, dev, pad = self.slots, self.cap, self.device, self.pad_token
        # key: (shape, dtype, value at the start of a run)
        init = dict(last_tok=((B, 1), torch.int64, pad),
                    live=((B,), torch.bool, False),
                    pending=((B,), torch.bool, False),
                    n_gen=((B,), torch.int32, 0),
                    max_new=((B,), torch.int32, 0),
                    stop=((B,), torch.int32, -1),
                    out=((B, cap), torch.int32, pad))
        if self.temperature > 0:
            init["keys"] = ((B, 2), torch.int64, 0)
        if self.draft_k:
            init.update(n_drafted=((), torch.int32, 0),
                        n_accepted=((), torch.int32, 0),
                        acc_ema=((), torch.float32, 1.0),
                        rung=((), torch.int32, 0))
        if self.paged is not None:
            init["ref"] = ((self.paged.n_blocks,), torch.int32, 0)
            if self.graphs:
                init["chunk_tok"] = ((1, self.prefill_chunk), torch.int64,
                                     pad)
        if self._st is None:
            st = {k: torch.empty(shape, dtype=dt, device=dev)
                  for k, (shape, dt, _) in init.items()}
            if self.paged is not None:
                lay = self.paged
                st["cache"] = lm.init_paged_cache(
                    self.cfg, B, lay.n_blocks, lay.block_size, lay.n_tbl,
                    device=dev)
            else:
                st["cache"] = lm.init_cache(self.cfg, B, self.max_seq,
                                            device=dev)
            if self.obs is not None:
                st["obs"] = obs_rings.init_obs_state(self.obs, dev)
                # the step bodies' int32 constants (branch codes, zero),
                # made outside any capture
                st["obs_k"] = torch.arange(4, dtype=torch.int32, device=dev)
            self._st = st
        st = self._st
        for k, (_, _, value) in init.items():
            st[k].fill_(value)
        for t in st["cache"].values():
            t.zero_()
        if self.paged is not None:
            st["ref"][0] = 1                    # the trash block's pin
        if self.obs is not None:
            obs_rings.reset_obs_state(st["obs"])
        return st

    def _tick(self, st: Dict, live: torch.Tensor, tok: torch.Tensor,
              drafted=None, accepted=None, stall=None) -> None:
        """A step body's ring sample (``obs_rings.iter_tick``), int32
        device values, at the device clock, which it then advances."""
        obs, k = st["obs"], st["obs_k"]
        free = ((st["ref"] == 0).sum(dtype=torch.int32)
                if self.paged is not None else None)
        obs_rings.iter_tick(
            obs, obs["n_iter"], k[self._branch_code["step"]], live,
            k[0] if drafted is None else drafted,
            k[0] if accepted is None else accepted, free, tok=tok,
            stall=stall)
        obs["n_iter"].add_(1)

    def _first_token(self, st: Dict, slot: int, logits: torch.Tensor,
                     key: Optional[torch.Tensor]) -> torch.Tensor:
        """A request's first token from its last prompt logits (1, V):
        at temperature, drawn with one split of its stream ``key``, whose
        other half becomes the slot's key."""
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        ks = prng.split(key)
        st["keys"][slot] = ks[0]
        return sample_rows(logits, ks[1:], self.temperature)

    def _arm_slot(self, st: Dict, slot: int, prompt: torch.Tensor,
                  max_new: int, stop: int, rid: int = 0) -> None:
        """Reset + prefill ``slot`` with one request (its sampling stream
        from ``rid``) and take its first token.  A request can finish ON
        that token; the event is parked in the pending mask like any step
        finish."""
        logits, st["cache"] = lm.prefill_into_slot(
            self._params, self.cfg, prompt, st["cache"], slot)
        tok = self._first_token(st, slot, logits[:, -1],
                                self._request_key(rid))      # (1,)
        fin0 = (tok == stop) | (max_new <= 1)
        st["last_tok"][slot] = tok
        st["out"][slot] = self.pad_token
        st["out"][slot, 0] = tok[0]
        st["n_gen"][slot] = 1
        st["max_new"][slot] = max_new
        st["stop"][slot] = stop
        st["live"][slot] = ~fin0[0]
        st["pending"][slot] = fin0[0]

    def _request_key(self, rid: int) -> Optional[torch.Tensor]:
        """A request's sampling stream: the base key folded with its
        rid (None when greedy)."""
        if self.temperature <= 0:
            return None
        return prng.fold_in(self._base_key, rid)

    def _subkeys(self, st: Dict, live: torch.Tensor) -> torch.Tensor:
        """One split of every slot's key: the live slots keep the first
        half (written in place), and the second halves (B, 2) are
        returned for this draw."""
        splits = prng.split(st["keys"])                       # (B, 2, 2)
        st["keys"].copy_(torch.where(live[:, None], splits[:, 0],
                                     st["keys"]))
        return splits[:, 1]

    def _sample(self, st: Dict, logits: torch.Tensor, live: torch.Tensor
                ) -> torch.Tensor:
        """The pool's tokens from logits (B, V): greedy, or one draw from
        every slot's stream."""
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        return sample_rows(logits, self._subkeys(st, live), self.temperature)

    def _step(self, st: Dict) -> None:
        """One pooled decode step; finishes land in pending.  Every
        changed entry of ``st`` is written in place (a captured body)."""
        live = st["live"]
        logits, _ = lm.decode_step(self._params, self.cfg, st["last_tok"],
                                   st["cache"], live=live)
        tok = self._sample(st, logits[:, -1], live).to(torch.int32)
        tok = torch.where(live, tok, self.pad_token)
        ar = torch.arange(self.slots, device=self.device)
        idx = torch.clamp(st["n_gen"], max=self.cap - 1).long()
        row = st["out"][ar, idx]
        st["out"][ar, idx] = torch.where(live, tok, row)
        n_gen = st["n_gen"] + live.to(torch.int32)
        finished = live & ((tok == st["stop"]) | (n_gen >= st["max_new"]))
        if self.obs is not None:
            # every live slot emits one token, so none stalls
            n_live = live.sum(dtype=torch.int32)
            self._tick(st, n_live, n_live, stall=0)
        st["last_tok"].copy_(tok[:, None])
        st["n_gen"].copy_(n_gen)
        st["pending"].logical_or_(finished)
        st["live"].copy_(live & ~finished)          # last: ``live`` is it

    def _spec_step(self, st: Dict, K: int) -> None:
        """One speculative round as a pooled step: K draft steps under
        ``draft_cfg`` (same pack), the positions rolled back, one verify
        forward over the K+1 positions, then the longest agreeing prefix
        plus the verify model's correction (at temperature: rejection
        sampling, ``rejection_accept``, each draw one split of the slot's
        key), 1..K+1 tokens a live slot,
        clamped by its budget and cut after a stop token.  The draft
        counters and the acceptance EMA (and from it the next round's
        rung) are updated on the device, and every changed entry of
        ``st`` is written in place (a captured body)."""
        live, pad = st["live"], self.pad_token
        cache, last, drafts, d_logits = st["cache"], st["last_tok"], [], []
        pos = cache["pos"]
        pos0 = pos.clone()
        for _ in range(K):
            logits, _ = lm.decode_step(self._params, self.draft_cfg, last,
                                       cache, live=live)
            dtok = torch.where(live, self._sample(st, logits[:, -1], live),
                               pad)
            drafts.append(dtok)
            if self.temperature > 0:
                d_logits.append(logits[:, -1])
            last = dtok[:, None]
        drafts = torch.stack(drafts, dim=1)                  # (B, K)
        pos.copy_(pos0)                                      # rollback
        vlogits, _ = lm.verify_step(
            self._params, self.cfg, torch.cat([st["last_tok"], drafts], 1),
            cache, live=live)
        if self.temperature <= 0:
            emitted, n_acc = greedy_accept(drafts, vlogits)
        else:
            u = prng.uniform(self._subkeys(st, live), (K,))
            n_acc, res = rejection_accept(drafts, torch.stack(d_logits, 1),
                                          vlogits, u, self.temperature)
            emitted = place_correction(drafts, n_acc, prng.categorical(
                self._subkeys(st, live), res))
        emitted = emitted.to(torch.int32)
        cols = torch.arange(K + 1, device=self.device)[None, :]
        allowed = torch.clamp_min(st["max_new"] - st["n_gen"], 0)
        n_emit = torch.minimum(n_acc + 1, allowed)
        is_stop = (emitted == st["stop"][:, None]) & (cols < n_emit[:, None])
        has_stop = is_stop.any(dim=1)
        n_emit = torch.where(has_stop,
                             torch.argmax(is_stop.to(torch.int32), dim=1) + 1,
                             n_emit)
        n_emit = torch.where(live, n_emit, 0).to(torch.int32)
        ar = torch.arange(self.slots, device=self.device)
        out = st["out"]
        for j in range(K + 1):
            idx = torch.clamp(st["n_gen"] + j, max=self.cap - 1).long()
            out[ar, idx] = torch.where(j < n_emit, emitted[:, j],
                                       out[ar, idx])
        n_gen = st["n_gen"] + n_emit
        finished = live & (has_stop | (n_gen >= st["max_new"]))
        new_last = torch.gather(
            emitted, 1, torch.clamp_min(n_emit - 1, 0)[:, None].long())
        drafted = (live.to(torch.int32) * K).sum()
        accepted = torch.where(live, n_acc, 0).sum()
        rate = (accepted.to(torch.float32)
                / torch.clamp_min(drafted, 1).to(torch.float32))
        ema = torch.where(drafted > 0, 0.8 * st["acc_ema"] + 0.2 * rate,
                          st["acc_ema"])
        R = len(self._rungs)
        if self.obs is not None:
            self._tick(st, live.sum(dtype=torch.int32),
                       n_emit.sum(dtype=torch.int32),
                       drafted.to(torch.int32), accepted.to(torch.int32))
        st["last_tok"].copy_(torch.where(n_emit[:, None] > 0,
                                         new_last.long(), st["last_tok"]))
        pos.copy_(pos0 + n_emit)
        st["n_gen"].copy_(n_gen)
        st["pending"].logical_or_(finished)
        st["n_drafted"].add_(drafted)
        st["n_accepted"].add_(accepted)
        st["acc_ema"].copy_(ema)
        st["rung"].copy_(torch.where(
            ema > 0.8, 0, torch.where(ema > 0.4, min(1, R - 1), R - 1)))
        st["live"].copy_(live & ~finished)          # last: ``live`` is it

    # -- host-side staging ---------------------------------------------

    def _check(self, requests: Sequence[Request]) -> None:
        for r in requests:
            if r.max_new_tokens > self.cap:
                raise ValueError(
                    f"request {r.rid}: max_new_tokens {r.max_new_tokens} "
                    f"> cap {self.cap}")
            if self.paged is not None:
                plen = len(r.prompt)
                if not (1 <= plen <= self.prompt_len):
                    raise ValueError(
                        f"request {r.rid}: prompt len {plen} outside "
                        f"[1, {self.prompt_len}]")
                if (self.cfg.family in lm.RECURRENT_FAMILIES
                        and plen % self.prefill_chunk):
                    raise ValueError(
                        f"request {r.rid}: prompt len {plen} must be a "
                        f"multiple of prefill_chunk {self.prefill_chunk} "
                        f"for the {self.cfg.family!r} family (a garbage "
                        "chunk tail would corrupt the recurrent state)")
                need = max(cdiv(plen, self.prefill_chunk)
                           * self.prefill_chunk,
                           plen + r.max_new_tokens - 1 + self.draft_k)
                if need > self.paged.tokens_per_slot:
                    raise ValueError(
                        f"request {r.rid}: needs {need} addressable tokens"
                        f" > table capacity {self.paged.tokens_per_slot}")
            elif len(r.prompt) != self.prompt_len:
                raise ValueError(
                    f"request {r.rid}: prompt len {len(r.prompt)} != "
                    f"scheduler prompt_len {self.prompt_len}")
        if len({r.rid for r in requests}) != len(requests):
            raise ValueError("request rids must be unique within a run")

    def _stage(self, requests: Sequence[Request],
               arrival_iters: Optional[Sequence[int]] = None) -> Dict:
        """The workload's host plan and its device buffers: prompts padded
        to the prefill span, each request's arrival iteration (0 by
        default), and (paged) the prefix plan, per-request block grants
        and pin counts."""
        n = len(requests)
        if arrival_iters is not None and len(arrival_iters) != n:
            raise ValueError("arrival_iters length != len(requests)")
        toks = np.full((n, self._p_pad), self.pad_token, np.int64)
        for i, r in enumerate(requests):
            toks[i, :len(r.prompt)] = np.asarray(r.prompt)
        plan = dict(q_toks=torch.from_numpy(toks).to(self.device),
                    arrival=([0] * n if arrival_iters is None
                             else [int(a) for a in arrival_iters]))
        if self.paged is None:
            return plan
        lay, C = self.paged, self.prefill_chunk
        # a shared prefix reuses KV blocks; recurrent state has none
        pp = plan_prefix_sharing([np.asarray(r.prompt) for r in requests],
                                 lay.block_size, lay.n_tbl,
                                 enable=(self.prefix_sharing
                                         and self.cfg.family
                                         not in lm.RECURRENT_FAMILIES))
        self.last_prefix_plan = pp
        max_blk = np.array([lay.blocks_for(max(
            cdiv(len(r.prompt), C) * C,
            len(r.prompt) + r.max_new_tokens - 1 + self.draft_k))
            for r in requests], np.int64)
        # static no-deadlock guarantee: even with every pinned shared
        # block held live by a not-yet-admitted sharer, the pool can
        # satisfy the largest single fresh grant
        n_pinned = int(np.sum(pp.pin_counts > 0))
        worst = int(np.max(max_blk - pp.n_shared_blocks, initial=0))
        if worst + n_pinned > lay.n_blocks - 1:
            raise ValueError(
                f"paged pool too small: worst-case fresh grant {worst}"
                f" + {n_pinned} pinned shared blocks > "
                f"{lay.n_blocks - 1} allocatable blocks")
        plan.update(prefix=pp, max_blk=max_blk,
                    q_pins=torch.from_numpy(
                        pp.pin_counts.astype(np.int32)).to(self.device))
        return plan

    # -- the serve loop ------------------------------------------------

    def run(self, requests: Sequence[Request],
            arrival_iters: Optional[Sequence[int]] = None,
            on_branch=None) -> ServeReport:
        """Serve ``requests`` to completion, admitting them in queue
        order, request i no earlier than iteration ``arrival_iters[i]``
        (an open-loop schedule in loop iterations; default: all at 0).
        ``on_branch`` (a function of the branch name, then of None when
        the branch is done) marks each iteration's branch for a caller
        that records what the branches run (``obs/fingerprint.py``)."""
        return self._serve(requests, arrival_iters, on_branch)[0]

    def run_instrumented(self, requests: Sequence[Request],
                         arrival_iters: Optional[Sequence[int]] = None):
        """``run``, with the loop's timeline: returns (report, timeline),
        timeline ``branch`` (each iteration's branch, as the reference's
        switch index: harvest 0, admit 1, prefill 2 (paged), step 3
        (paged) or 2) and ``iter_s`` (each iteration's seconds, between
        the host's flags reads).  The loop reads the host clock at every
        iteration in ``run`` too, so this is the same program."""
        return self._serve(requests, arrival_iters, None)

    def _serve(self, requests, arrival_iters, on_branch):
        self._check(requests)
        with torch.inference_mode(), self._collector():
            return self._run(requests, arrival_iters, on_branch)

    def _collector(self, st: Optional[Dict] = None):
        """With telemetry on, one collector frame over a run whose
        ``adc_clip`` buffer is the rings' counter slot: the GEMMs add
        their ADC clips there (kernel rows 1 and 2 directly, so a step
        graph captured inside it counts at every replay).  ``st`` is a
        run's pool state in progress (default: the state reset for a new
        run)."""
        if self.obs is None:
            return contextlib.nullcontext()
        ctr = (self._state() if st is None else st)["obs"]["ctr"]
        return taps.collect(adc_clip=ctr[obs_rings.CTR_ADC_CLIP:
                                         obs_rings.CTR_ADC_CLIP + 1])

    def _run(self, requests: Sequence[Request], arrival_iters=None,
             on_branch=None):
        lp = self._begin(requests, arrival_iters)
        self._iterate(lp, on_branch=on_branch)
        return self._finish(lp)

    def _begin(self, requests: Sequence[Request], arrival_iters=None
               ) -> "_Loop":
        """A run's start: the workload staged, the pool state reset, the
        per-request result buffers made and the host mirrors at zero."""
        lp = _Loop()
        lp.requests, lp.n = requests, len(requests)
        lp.plan = self._stage(requests, arrival_iters)
        lp.st = self._state()
        dev, n = self.device, lp.n
        # the eager branches' ring records
        lp.rec = obs_rings.EagerRecords() if self.obs is not None else None
        if self.paged is not None:
            NB, n_tbl = self.paged.n_blocks, self.paged.n_tbl
            lp.ar_nb = torch.arange(NB, dtype=torch.int32, device=dev)
            lp.j_tbl = torch.arange(n_tbl, device=dev)
            lp.req_tables = torch.zeros((n, n_tbl), dtype=torch.int32,
                                        device=dev)
            lp.peak = torch.zeros((), dtype=torch.int32, device=dev)
        lp.res_out = torch.full((n, self.cap), self.pad_token,
                                dtype=torch.int32, device=dev)
        lp.res_n = torch.zeros((n,), dtype=torch.int32, device=dev)
        B = self.slots
        lp.occupant, lp.filling, lp.fill_pos = [-1] * B, [False] * B, [0] * B
        lp.pf_done = [False] * n
        lp.res_iter, lp.res_first = [0] * n, [0] * n
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        lp.t0 = time.perf_counter()
        return lp

    def _fault_clock(self, st: Dict) -> Optional[torch.Tensor]:
        """Under an armed fault model (``resilience/faults.py``), the pool
        state's device clock (0-d int32) that every branch's GEMMs read
        the drift schedule at; None otherwise."""
        if not faults.active():
            return None
        if "fault_clock" not in st:
            st["fault_clock"] = torch.zeros((), dtype=torch.int32,
                                            device=self.device)
        return st["fault_clock"]

    def _iterate(self, lp: "_Loop", budget: Optional[int] = None,
                 on_branch=None) -> bool:
        """Run ``lp``'s loop until the queue is served, or (``budget``)
        until its iteration count reaches ``budget``: the guarded server's
        segment, after which the loop resumes exactly where it stopped,
        in this scheduler or a sibling on the same pool state.  Returns
        whether the queue is served.  Under an armed fault model each
        iteration first writes its index into the device clock."""
        fclock = self._fault_clock(lp.st)
        with (faults.clock(fclock) if fclock is not None
              else contextlib.nullcontext()):
            return self._loop(lp, budget, on_branch, fclock)

    def _loop(self, lp: "_Loop", budget, on_branch, fclock) -> bool:
        n, B, paged = lp.n, self.slots, self.paged
        st, plan, rec, requests = lp.st, lp.plan, lp.rec, lp.requests
        obs = st.get("obs")
        arrival = plan["arrival"]
        code = self._branch_code
        occupant, filling, fill_pos = lp.occupant, lp.filling, lp.fill_pos
        spec = self.draft_k > 0
        if paged is not None:
            NB, bs = paged.n_blocks, paged.block_size
            pp = plan["prefix"]
        while not lp.done:
            if budget is not None and lp.n_iter >= budget:
                break
            n_iter, q_head = lp.n_iter, lp.q_head
            parts = [st["pending"], st["live"]]
            if paged is not None:
                parts.append((st["ref"] == 0).sum()[None])
            if spec:
                parts += [st["rung"][None], st["n_drafted"][None],
                          st["n_accepted"][None]]
            flags = torch.cat([p.to(torch.int32) for p in parts]).cpu()
            lp.flags = flags
            lp.syncs += 1
            lp.iter_end.append(time.perf_counter() - lp.t0)
            pending = flags[:B].tolist()
            live = flags[B:2 * B].tolist()
            if rec is not None and paged is not None:
                rec.set_free(int(flags[2 * B]))     # the last branch's
            occupied = [p or lv or f for p, lv, f in
                        zip(pending, live, filling)]
            if not any(occupied) and q_head >= n:
                lp.done = True
                break
            if fclock is not None:
                fclock.fill_(n_iter)
            qh = min(q_head, n - 1)
            can_admit = (q_head < n and not all(occupied)
                         and arrival[qh] <= n_iter)
            if paged is not None:
                n_sh = int(pp.n_shared_blocks[qh])
                src = int(pp.share_src[qh])
                can_admit = (can_admit and (n_sh == 0 or lp.pf_done[src])
                             and int(flags[2 * B]) >= plan["max_blk"][qh] - n_sh)
                want_pf = any(filling) and (not any(live) or not lp.last_pf)
            else:
                want_pf = False
            live0 = sum(live)
            if any(pending):
                branch = "harvest"
                if on_branch is not None:
                    on_branch(branch)
                slot = pending.index(1)
                qidx = occupant[slot]
                lp.res_out[qidx] = st["out"][slot]
                lp.res_n[qidx] = st["n_gen"][slot]
                lp.res_iter[qidx] = n_iter
                if rec is not None:
                    rec.push(obs_rings.EV_FINISH, requests[qidx].rid, n_iter)
                st["pending"][slot] = False
                occupant[slot] = -1
                if paged is not None:
                    # one ref off each block of the grant (shared entries
                    # included: the donor pinned one ref per chain through
                    # them), then park the table on the trash block
                    grant = st["cache"]["table"][slot, :plan["max_blk"][qidx]]
                    st["ref"].index_add_(0, grant.long(),
                                         torch.full_like(grant, -1))
                    st["cache"]["table"][slot] = 0
                if rec is not None:
                    rec.tick(n_iter, code[branch], live0, 0,
                             free_blocks=None if paged is not None else -1)
            elif can_admit:
                branch = "admit"
                if on_branch is not None:
                    on_branch(branch)
                slot = occupied.index(False)
                qidx, r = q_head, requests[q_head]
                occupant[slot] = qidx
                if rec is not None:
                    rec.push(obs_rings.EV_ADMIT, r.rid, n_iter)
                if paged is None:
                    self._arm_slot(st, slot, plan["q_toks"][qidx:qidx + 1],
                                   r.max_new_tokens, r.stop_token, r.rid)
                    lp.res_first[qidx] = n_iter
                    if rec is not None:
                        # the whole-prompt prefill samples the first token
                        rec.push(obs_rings.EV_FIRST, r.rid, n_iter)
                        rec.tick(n_iter, code[branch], live0, 1)
                else:
                    n_blk = int(plan["max_blk"][qidx])
                    # the free list is the refcount vector: argsort(free
                    # first, by id) makes the grant deterministic, and the
                    # admission gate guaranteed enough free blocks
                    order = torch.argsort(torch.where(
                        st["ref"] == 0, lp.ar_nb, NB + lp.ar_nb))
                    fresh = order[torch.clamp(lp.j_tbl - n_sh, 0, NB - 1)]
                    shared = lp.req_tables[max(src, 0)]
                    row = torch.where(
                        lp.j_tbl < n_sh, shared,
                        torch.where(lp.j_tbl < n_blk, fresh.to(torch.int32),
                                    0))
                    # fresh blocks come up at ref 1 (+ pins for later
                    # chains through them); shared blocks were pinned by
                    # their materializer
                    st["ref"].index_add_(
                        0, row[n_sh:n_blk].long(),
                        1 + plan["q_pins"][qidx, n_sh:n_blk])
                    lp.peak = torch.maximum(lp.peak,
                                            (st["ref"] > 0).sum() - 1)
                    cache = lm.reset_slot(st["cache"], slot)
                    # a sharer starts its chunk walk at the last chunk
                    # boundary inside the shared region: the few
                    # recomputed rows equal what the donor wrote
                    s0 = (n_sh * bs) // self.prefill_chunk * self.prefill_chunk
                    cache["table"][slot] = row
                    cache["pos"][slot] = s0
                    lp.req_tables[qidx] = row
                    filling[slot], fill_pos[slot] = True, s0
                    st["live"][slot] = False
                    st["pending"][slot] = False
                    st["n_gen"][slot] = 0
                    st["max_new"][slot] = r.max_new_tokens
                    st["stop"][slot] = r.stop_token
                    st["out"][slot] = self.pad_token
                    if self.temperature > 0:
                        st["keys"][slot] = self._request_key(r.rid)
                    if rec is not None:
                        rec.add(obs_rings.CTR_PREFIX_BLOCKS, n_sh)
                        rec.add(obs_rings.CTR_SHARED_ADMITS, int(n_sh > 0))
                        rec.tick(n_iter, code[branch], live0, 0,
                                 free_blocks=None)
                lp.q_head += 1
            elif want_pf:
                branch = "prefill"
                if on_branch is not None:
                    on_branch(branch)
                slot = filling.index(True)
                qidx, r = occupant[slot], requests[occupant[slot]]
                C, plen, start = self.prefill_chunk, len(r.prompt), fill_pos[slot]
                logits = self._prefill_chunk(
                    st, slot, plan["q_toks"][qidx:qidx + 1, start:start + C])
                done = start + C >= plen
                if done:
                    # the final chunk ran to the padded span; commit pos =
                    # plen so decode writes land right after the prompt
                    row = min(plen - 1 - start, C - 1)
                    key = st["keys"][slot] if "keys" in st else None
                    tok = self._first_token(st, slot, logits[:, row],
                                            key)[0]
                    fin0 = (tok == r.stop_token) | (r.max_new_tokens <= 1)
                    st["cache"]["pos"][slot] = plen
                    st["last_tok"][slot, 0] = tok
                    st["out"][slot, 0] = tok
                    st["n_gen"][slot] = 1
                    st["live"][slot] = ~fin0
                    st["pending"][slot] = fin0
                    filling[slot] = False
                    lp.pf_done[qidx] = True
                    lp.res_first[qidx] = n_iter
                    if rec is not None:
                        rec.push(obs_rings.EV_FIRST, r.rid, n_iter)
                else:
                    fill_pos[slot] = start + C
                if rec is not None:
                    rec.tick(n_iter, code[branch], live0, int(done),
                             free_blocks=None)
                lp.last_pf = True
            else:
                branch = "step"
                if on_branch is not None:
                    on_branch(branch)
                if obs is not None and lp.clock != n_iter:
                    obs["n_iter"].fill_(n_iter)       # after eager branches
                lp.clock = n_iter + 1
                if spec:
                    # the rung sits after the masks and the free count
                    K = self._rungs[int(flags[2 * B + (paged is not None)])]
                    self._advance(st, K)
                    lp.draft_steps += K
                else:
                    self._advance(st)
                lp.last_pf = False
            if on_branch is not None:
                on_branch(None)
            lp.branches.append(branch)
            lp.n_iter += 1
        return lp.done

    def _finish(self, lp: "_Loop"):
        """The report (and timeline) of a served loop ``lp``."""
        B, paged, obs = self.slots, self.paged, lp.st.get("obs")
        n_iter, iter_end, branches = lp.n_iter, lp.iter_end, lp.branches
        wall = time.perf_counter() - lp.t0
        # iteration k runs from flags read k to flags read k + 1
        counts = dict.fromkeys(BRANCHES, 0)
        times = dict.fromkeys(BRANCHES, 0.0)
        for k, b in enumerate(branches):
            counts[b] += 1
            times[b] += iter_end[k + 1] - iter_end[k]
        res_out_h = lp.res_out.cpu().numpy()
        res_n_h = lp.res_n.cpu().numpy()
        done = [FinishedRequest(
            rid=r.rid, tokens=res_out_h[i, :res_n_h[i]].copy(),
            latency_s=iter_end[lp.res_iter[i] + 1],
            finish_iter=lp.res_iter[i], first_iter=lp.res_first[i],
            ttft_s=iter_end[lp.res_first[i] + 1])
            for i, r in enumerate(lp.requests)]
        report = ServeReport(
            finished=done, wall_s=wall, n_steps=counts["step"],
            n_admits=counts["admit"], slots=B, n_pf=counts["prefill"],
            n_iter=n_iter, host_syncs=lp.syncs, branch_counts=counts,
            branch_s=times, draft_steps=lp.draft_steps)
        if self.draft_k > 0:
            # the last flags read came after the last round
            report.n_drafted, report.n_accepted = (int(lp.flags[-2]),
                                                   int(lp.flags[-1]))
        if paged is not None:
            report.peak_blocks = int(lp.peak)
            report.ref_final = lp.st["ref"].cpu().numpy()
        if obs is not None:
            lp.rec.apply(obs)
            report.obs = obs_rings.harvest_obs(
                self.obs, obs, n_iter=n_iter, wall_s=wall, slots=B,
                n_steps=report.n_steps, n_drafted=report.n_drafted,
                n_accepted=report.n_accepted, paged=paged is not None)
        code = self._branch_code
        timeline = dict(
            branch=np.asarray([code[b] for b in branches], np.int32),
            iter_s=np.diff(np.asarray(iter_end)))
        return report, timeline

    def run_lockstep(self, requests: Sequence[Request]) -> ServeReport:
        """Lock-step baseline through the SAME per-slot machinery: waves
        of ``slots`` requests all decode to the wave's longest budget, and
        per-request stop handling is applied afterwards by truncation, so
        the difference to ``run`` is scheduling alone (same kernels, admit
        path and step math).  One host read per wave."""
        if self.paged is not None:
            raise ValueError("run_lockstep is the contiguous baseline; "
                             "build the scheduler without paged=")
        self._check(requests)
        plan = self._stage(requests)
        done: List[FinishedRequest] = []
        n_steps = n_admits = syncs = 0
        with torch.inference_mode(), self._collector():
            st = self._state()
            t0 = time.perf_counter()
            for w0 in range(0, len(requests), self.slots):
                wave = list(requests[w0:w0 + self.slots])
                wave_max = max(r.max_new_tokens for r in wave)
                for slot, r in enumerate(wave):
                    # stop -1, budget wave_max: every slot decodes the wave
                    i = w0 + slot
                    self._arm_slot(st, slot, plan["q_toks"][i:i + 1],
                                   wave_max, -1, r.rid)
                    n_admits += 1
                for _ in range(wave_max - 1):
                    self._advance(st)
                n_steps += wave_max - 1
                out_h = st["out"].cpu().numpy()
                syncs += 1
                t_wave = time.perf_counter() - t0
                for slot, r in enumerate(wave):
                    toks = out_h[slot, :wave_max]
                    n = r.max_new_tokens
                    if r.stop_token >= 0:
                        hits = np.nonzero(toks == r.stop_token)[0]
                        if hits.size:
                            n = min(n, int(hits[0]) + 1)
                    done.append(FinishedRequest(
                        rid=r.rid, tokens=toks[:n].copy(), latency_s=t_wave,
                        finish_iter=n_steps + n_admits))
            wall = time.perf_counter() - t0
        return ServeReport(finished=done, wall_s=wall, n_steps=n_steps,
                           n_admits=n_admits, slots=self.slots,
                           n_iter=n_steps + n_admits, host_syncs=syncs)


def place_correction(drafts: torch.Tensor, n_acc: torch.Tensor,
                     corr: torch.Tensor) -> torch.Tensor:
    """A round's emitted block (B, K+1): the drafts, with column n_acc
    replaced by the correction ``corr`` ((B, K+1) per column, or (B,))."""
    K = drafts.shape[1]
    cand = torch.cat([drafts, drafts[:, -1:]], dim=1)
    cols = torch.arange(K + 1, device=drafts.device)[None, :]
    if corr.dim() == 1:
        corr = corr[:, None]
    return torch.where(cols == n_acc[:, None], corr, cand)


def greedy_accept(drafts: torch.Tensor, vlogits: torch.Tensor):
    """The greedy accept rule of a speculative round: drafts (B, K) and
    the verify logits (B, K+1, V) -> (emitted (B, K+1), n_acc (B,)).
    Verify position i predicts the token after [last, d_1..d_i]; the
    longest prefix of drafts equal to those predictions is accepted, and
    column n_acc holds the verify model's own token (the correction, or
    the bonus token after a fully accepted block)."""
    K = drafts.shape[1]
    v_arg = torch.argmax(vlogits, dim=-1)
    n_acc = torch.cumprod((v_arg[:, :K] == drafts).to(torch.int32),
                          dim=1).sum(dim=1)
    return place_correction(drafts, n_acc, v_arg), n_acc


def _params_device(params) -> torch.device:
    """The device of the first tensor in a params tree."""
    stack = [params]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, dict):
            stack.extend(v.values())
        elif dataclasses.is_dataclass(v):
            stack.extend(getattr(v, f.name) for f in dataclasses.fields(v))
    raise ValueError("params hold no tensor")


def mixed_length_requests(n: int, prompt_len: int, vocab_size: int,
                          stop_lengths: Sequence[int] = (4, 16, 8, 12),
                          seed: int = 0) -> List[Request]:
    """Synthetic mixed-length workload: request i stops after
    ``stop_lengths[i % len]`` tokens.  The interleaving is deliberately
    adversarial for lock-step waves (short and long requests share one)."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab_size, prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=int(stop_lengths[i % len(stop_lengths)]))
            for i in range(n)]


def shared_prefix_requests(n: int, prefix_len: int, min_len: int,
                           max_len: int, vocab_size: int,
                           stop_lengths: Sequence[int] = (4, 16, 8, 12),
                           seed: int = 0) -> List[Request]:
    """Mixed-length workload in which every other request (the even rids)
    starts with one shared ``prefix_len``-token prefix, as tenants behind
    one system prompt do; prompt lengths are drawn from [min_len,
    max_len], and the sharers' from [prefix_len + 1, max_len]."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab_size, prefix_len, dtype=np.int32)
    reqs = []
    for i in range(n):
        if i % 2 == 0:
            tail = int(rng.integers(max(min_len, prefix_len + 1) - prefix_len,
                                    max_len - prefix_len + 1))
            prompt = np.concatenate(
                [prefix, rng.integers(0, vocab_size, tail, dtype=np.int32)])
        else:
            prompt = rng.integers(0, vocab_size,
                                  int(rng.integers(min_len, max_len + 1)),
                                  dtype=np.int32)
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=int(
                                stop_lengths[i % len(stop_lengths)])))
    return reqs


def multi_tenant_trace(n_requests: int, max_prompt: int, vocab: int,
                       block_size: int, n_tenants: int = 3, seed: int = 0,
                       arrival_rate: float = 0.5):
    """Open-loop multi-tenant workload (the reference's
    ``benchmarks/serve_bench.py::multi_tenant_trace``, draw for draw):
    ``n_tenants`` tenants, each with a shared system prompt (a
    block-aligned prefix the paged scheduler can share), per-request tails
    of mixed length, decode budgets of 4-12 tokens and Poisson arrivals
    (exponential inter-arrival times in loop iterations).  Prompts top out
    at ``max_prompt``; request 0 is the one long prompt (the
    admission-stall stressor), the rest are chat-sized.  Returns
    (requests, arrival_iters)."""
    rng = np.random.default_rng(seed)
    pre_blocks = [3, 1, 2, 4, 2, 3][:n_tenants]
    prefixes = [rng.integers(0, vocab, nb * block_size, dtype=np.int32)
                for nb in pre_blocks]
    reqs, arrivals = [], []
    t = 0.0
    for i in range(n_requests):
        pre = prefixes[i % n_tenants]     # round-robin keeps tenants mixed
        if i == 0:
            tail = max_prompt - len(pre)
        else:
            tail = int(rng.integers(
                1, min(max_prompt - len(pre), 3 * block_size) + 1))
        prompt = np.concatenate(
            [pre, rng.integers(0, vocab, tail, dtype=np.int32)])
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=int(rng.integers(4, 13))))
        arrivals.append(int(t))
        t += rng.exponential(1.0 / arrival_rate)
    return reqs, arrivals
