"""Port parity: serving telemetry (``repro_torch/obs``) against the
reference's ``repro/obs``, on the minicpm-2b smoke model with packed CIM
weights taken from the reference ``lm.init`` through
``convert.params_from_jax``.

The reference's telemetry contract, held on the port:

1. tokens with metrics on equal tokens with metrics off (contiguous,
   paged and speculative pools, greedy and at T 0.7), and the loop reads
   the device once an iteration either way (``host_syncs == n_iter + 1``);
2. the rings tell the truth: ring TTFT equals ``run_instrumented``'s
   ``first_iter``, an overflowing ring saturates (counters stay exact),
   and the harvested snapshot equals the reference's -- counters (ADC
   clips included), events, spans, TTFT iterations, every per-iteration
   sample and ``n_iter`` -- with only the wall-clock fields excluded;
3. the off switch is real: the op-sequence fingerprint of a metrics-off
   scheduler is deterministic, a metrics-on one differs, and so does one
   of other ring capacities;

plus the host half: the registry's exports equal the reference's for the
same calls, and the Prometheus exposition parses.  Every comparison is
``==``.  Each reference scheduler runs once per module (a fixture).
"""
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import ccim as jccim
from repro.launch import scheduler as JS
from repro.launch.paging import PagedLayout as JLayout
from repro.launch.serve import serve_continuous as j_serve_continuous
from repro.models import lm as jlm
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import ObsConfig as JObs
from repro.obs import rings as JR
from repro.obs import taps as jtaps
from repro.plan import draft_plan_for_model as jdraft
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.core import ccim as tccim
from repro_torch.launch import scheduler as TS
from repro_torch.launch.paging import PagedLayout as TLayout
from repro_torch.launch.serve import (serve, serve_continuous,
                                      serve_speculative)
from repro_torch.models import lm as tlm
from repro_torch.obs import MetricsRegistry, ObsConfig
from repro_torch.obs import rings as R
from repro_torch.obs import scheduler_fingerprint, taps
from repro_torch.plan import draft_plan_for_model as tdraft

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

P, CAP, SLOTS = 8, 4, 2
STOPS = (2, 4, 3, 4)
# the snapshot fields measured on the host clock
WALL = ("wall_s", "iter_s_est", "ttft_p50_s", "ttft_p95_s")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tcfg, "cpu")
    return (jlm.pack_cim_params(jp, jcfg), jcfg,
            tlm.pack_cim_params(tp, tcfg, "cpu"), tcfg, tp)


def _requests():
    return TS.mixed_length_requests(4, P, 512, stop_lengths=STOPS)


def _jreqs(reqs):
    return [JS.Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens,
                       stop_token=r.stop_token) for r in reqs]


def _variant(variant, jcfg=None, tcfg=None):
    """(reference kwargs, port kwargs) of a pool variant; ``spec5``
    drafts under the all-analog shadow at a 5-bit ADC, which clips."""
    if variant == "paged":
        return (dict(paged=JLayout(8, 2, 12)), dict(paged=TLayout(8, 2, 12)))
    if variant == "speculative":
        return dict(draft_k=2), dict(draft_k=2)
    if variant == "spec5":
        return (dict(draft_k=2, draft_plan=jdraft(jcfg, 5)),
                dict(draft_k=2, draft_plan=tdraft(tcfg, 5)))
    return {}, {}


SNAP_VARIANTS = ("contiguous", "paged", "spec5")


@pytest.fixture(scope="module")
def reference_snapshots(models):
    """The reference's metrics-on reports, one run per variant."""
    jp, jcfg, _, tcfg, _ = models
    out = {}
    for v in SNAP_VARIANTS:
        jkw, _ = _variant(v, jcfg, tcfg)
        out[v] = JS.ContinuousBatchingScheduler(
            jp, jcfg, slots=SLOTS, prompt_len=P, max_new_cap=CAP,
            obs=JObs(), **jkw).run(_jreqs(_requests()))
    return out


def _strip(d):
    d = {k: v for k, v in d.items() if k not in WALL}
    d["spans"] = [{k: v for k, v in s.items() if k != "ttft_s_est"}
                  for s in d["spans"]]
    return d


# ---------------------------------------------------------------------------
# 1. metrics on/off
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("variant", ["contiguous", "paged", "speculative"])
def test_tokens_equal_on_off(models, variant, temperature):
    _, _, tp, tcfg, _ = models
    _, kw = _variant(variant)
    kw.update(slots=SLOTS, prompt_len=P, max_new_cap=CAP,
              temperature=temperature)
    off = TS.ContinuousBatchingScheduler(tp, tcfg, **kw).run(_requests())
    on = TS.ContinuousBatchingScheduler(tp, tcfg, obs=ObsConfig(),
                                        **kw).run(_requests())
    assert off.obs is None and on.obs is not None
    want, got = off.tokens_by_rid(), on.tokens_by_rid()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))
    # the rings add no read of the device
    assert on.host_syncs == on.n_iter + 1 == off.n_iter + 1
    snap = on.obs
    assert snap.counters["tokens"] == sum(len(t) for t in want.values())
    assert sorted(s["rid"] for s in snap.spans) == sorted(want)
    for s in snap.spans:
        assert s["admit_iter"] <= s["first_iter"] <= s["finish_iter"]
    if variant == "speculative":
        assert snap.acceptance_rate == snap.acceptance_rate     # not NaN
    if variant == "paged":
        assert snap.min_free_blocks is not None


@pytest.mark.parametrize("variant", SNAP_VARIANTS)
def test_snapshot_equals_reference(models, reference_snapshots, variant):
    """Everything but the wall clock: counters (ADC clips of the 5-bit
    draft included), events, spans, TTFT iterations, n_iter and every
    per-iteration sample."""
    _, jcfg, tp, tcfg, _ = models
    _, tkw = _variant(variant, jcfg, tcfg)
    got = TS.ContinuousBatchingScheduler(
        tp, tcfg, slots=SLOTS, prompt_len=P, max_new_cap=CAP,
        obs=ObsConfig(), **tkw).run(_requests())
    want = reference_snapshots[variant]
    assert _strip(got.obs.to_dict()) == _strip(want.obs.to_dict())
    assert got.obs.events == want.obs.events
    assert got.obs.ttft_iters == want.obs.ttft_iters
    for k, v in want.obs.iter_samples.items():
        np.testing.assert_array_equal(got.obs.iter_samples[k], v,
                                      err_msg=k)
    if variant == "spec5":
        assert got.obs.counters["adc_clip"] > 0


def test_serve_continuous_telemetry_equals_reference(models):
    """The entry point: ``serve_continuous(metrics=True)`` on the
    reference's params, its ``stats["telemetry"]`` equal to the
    reference driver's, tokens equal to a metrics-off run."""
    _, _, _, _, tp_float = models
    kw = dict(smoke=True, slots=SLOTS, prompt_len=P, n_requests=4,
              stop_lengths=STOPS, cim=True, compare_lockstep=False)
    _, jst = j_serve_continuous("minicpm-2b", metrics=True, **kw)
    toks, st = serve_continuous("minicpm-2b", metrics=True, device="cpu",
                                params=tp_float, **kw)
    off, _ = serve_continuous("minicpm-2b", device="cpu", params=tp_float,
                              **kw)
    for rid in off:
        np.testing.assert_array_equal(toks[rid], off[rid])
    assert _strip(st["telemetry"]) == _strip(jst["telemetry"])
    assert {s["name"] for s in st["spans"]} == {
        "serve.pack", "serve.compile", "serve.workload"}
    assert (st["metrics"]["serve_tokens_total"][0]["value"]
            >= st["telemetry"]["counters"]["tokens"])


def test_lockstep_and_speculative_metrics(models):
    """``serve(metrics=True)`` and ``serve_speculative(metrics=True)``:
    tokens equal the metrics-off runs', the four spans are recorded and
    the registry counts the emitted tokens."""
    _, _, _, _, tp_float = models
    kw = dict(smoke=True, batch=2, prompt_len=8, gen=5, cim=True,
              device="cpu", params=tp_float, return_stats=True)
    spans = {"serve.pack", "serve.compile", "serve.prefill", "serve.decode"}
    off, _ = serve("minicpm-2b", **kw)
    on, st = serve("minicpm-2b", metrics=True, **kw)
    np.testing.assert_array_equal(on, off)
    assert spans <= {s["name"] for s in st["spans"]}
    before = st["metrics"]["serve_tokens_total"][0]["value"]
    off, _ = serve_speculative("minicpm-2b", draft_k=2,
                               compare_baseline=False, **kw)
    on, st = serve_speculative("minicpm-2b", draft_k=2, metrics=True,
                               compare_baseline=False, **kw)
    np.testing.assert_array_equal(on, off)
    assert spans <= {s["name"] for s in st["spans"]}
    assert st["metrics"]["serve_tokens_total"][0]["value"] == before + 10
    assert st["metrics"]["serve_drafted_total"][0]["value"] >= \
        st["n_drafted"]


# ---------------------------------------------------------------------------
# 2. ring truth: TTFT and overflow
# ---------------------------------------------------------------------------


def test_ring_ttft_equals_instrumented_first_iter(models):
    _, _, tp, tcfg, _ = models
    sched = TS.ContinuousBatchingScheduler(tp, tcfg, slots=SLOTS,
                                           prompt_len=P, max_new_cap=CAP,
                                           obs=ObsConfig())
    rep = sched.run(_requests())
    assert rep.obs.ttft_iters == {f.rid: f.first_iter
                                  for f in rep.finished}
    ri, timeline = sched.run_instrumented(_requests())
    assert rep.obs.ttft_iters == {f.rid: f.first_iter for f in ri.finished}
    assert len(timeline["branch"]) == len(timeline["iter_s"]) == ri.n_iter
    np.testing.assert_array_equal(ri.obs.iter_samples["branch"],
                                  timeline["branch"])


def test_ring_overflow_saturates_without_corrupting_tokens(models):
    _, _, tp, tcfg, _ = models
    kw = dict(slots=SLOTS, prompt_len=P, max_new_cap=CAP)
    want = TS.ContinuousBatchingScheduler(tp, tcfg, **kw).run(
        _requests()).tokens_by_rid()
    rep = TS.ContinuousBatchingScheduler(
        tp, tcfg, obs=ObsConfig(event_cap=4, iter_cap=2), **kw).run(
        _requests())
    for rid in want:
        np.testing.assert_array_equal(rep.tokens_by_rid()[rid], want[rid])
    snap = rep.obs
    assert snap.dropped_events == 3 * 4 - 4
    assert len(snap.events) == 4          # the recorded prefix survives
    assert snap.recorded_iters == 2
    assert snap.counters["tokens"] == sum(len(t) for t in want.values())
    assert json.dumps(snap.to_dict())


def test_ring_push_saturation_unit():
    """The port's ring_push against the reference's on the same pushes:
    the recorded rows and the cursor equal (the sink row is the port's
    spare, never read)."""
    cfg = ObsConfig(event_cap=3, iter_cap=2)
    obs = R.init_obs_state(cfg)
    jobs = JR.init_obs_state(JObs(event_cap=3, iter_cap=2))
    for i in range(5):
        R.ring_push(obs, R.EV_ADMIT, i, 10 + i)
        jobs = JR.ring_push(jobs, JR.EV_ADMIT, i, 10 + i)
    assert int(obs["ev_n"]) == int(jobs["ev_n"]) == 5
    np.testing.assert_array_equal(obs["ev"][:3].numpy(),
                                  np.asarray(jobs["ev"]))
    before = obs["ev"].clone()
    # a gated push neither writes nor advances the cursor
    R.ring_push(obs, R.EV_FINISH, 9, 99, do=torch.tensor(False))
    R.ring_push(obs, R.EV_FINISH, 9, 99, do=False)
    assert int(obs["ev_n"]) == 5
    assert torch.equal(obs["ev"][:3], before[:3])


def test_iter_tick_equals_reference():
    """iter_tick, ctr_add and the harvest on the same samples (ints and
    tensors mixed), saturating the sample ring."""
    cfg, jcfg = ObsConfig(event_cap=4, iter_cap=3), JObs(4, 3)
    obs, jobs = R.init_obs_state(cfg), JR.init_obs_state(jcfg)
    rows = [(0, 1, 2, 0, 0, 0, 7), (1, 3, 0, 0, 0, 0, 6),
            (2, 2, 1, 0, 0, 0, 5), (3, 3, 2, 4, 3, 0, 4),
            (4, 3, 2, 0, 0, 2, 9)]
    for n, br, live, dr, ac, tok, free in rows:
        R.iter_tick(obs, torch.tensor(n, dtype=torch.int32), br,
                    torch.tensor(live), dr, ac, free,
                    tok=torch.tensor(tok, dtype=torch.int32))
        jobs = dict(jobs, tick_tok=jnp.int32(tok))
        jobs = JR.iter_tick(jobs, n, br, live, dr, ac, free)
    R.ctr_add(obs, R.CTR_PREFIX_BLOCKS, 3)
    jobs = JR.ctr_add(jobs, JR.CTR_PREFIX_BLOCKS, 3)
    np.testing.assert_array_equal(obs["ctr"].numpy(), np.asarray(jobs["ctr"]))
    np.testing.assert_array_equal(obs["it"][:3].numpy(),
                                  np.asarray(jobs["it"]))
    kw = dict(n_iter=5, wall_s=0.5, slots=3, n_steps=2, paged=True)
    got = R.harvest_obs(cfg, obs, **kw)
    want = JR.harvest_obs(jcfg, jax.device_get(jobs), **kw)
    assert got.to_dict() == want.to_dict()


# ---------------------------------------------------------------------------
# 3. the off switch
# ---------------------------------------------------------------------------


def test_fingerprint_deterministic_on_off_and_capacity(models):
    _, _, tp, tcfg, _ = models
    mk = lambda **kw: TS.ContinuousBatchingScheduler(
        tp, tcfg, slots=SLOTS, prompt_len=P, max_new_cap=CAP, **kw)
    fp_off = scheduler_fingerprint(mk(), 2)
    assert scheduler_fingerprint(mk(), 2) == fp_off      # deterministic
    fp_on = scheduler_fingerprint(mk(obs=ObsConfig()), 2)
    assert fp_on != fp_off                               # ring ops
    assert fp_on != scheduler_fingerprint(
        mk(obs=ObsConfig(event_cap=8, iter_cap=8)), 2)   # ring shapes


# ---------------------------------------------------------------------------
# taps and the ADC clip count
# ---------------------------------------------------------------------------


def test_taps_frames():
    """No frame: emit is a no-op and sink None; a caller's buffer is
    added into in place; a name without one gets its own buffer."""
    assert not taps.active() and taps.sink("adc_clip") is None
    taps.emit("adc_clip", 5)
    buf = torch.zeros((1,), dtype=torch.int32)
    with taps.collect(adc_clip=buf) as fr:
        assert taps.active()
        taps.emit("adc_clip", torch.tensor(3, dtype=torch.int32))
        taps.emit("adc_clip", 4)
        taps.emit("other", torch.tensor(2, dtype=torch.int32))
        assert taps.sink("adc_clip") is buf
    assert not taps.active()
    assert int(buf) == 7 and int(taps.drain_sum(fr, "adc_clip")) == 7
    assert int(taps.drain_sum(fr, "other")) == 2
    assert int(taps.drain_sum(fr, "missing")) == 0
    with pytest.raises(ValueError):
        with taps.collect(adc_clip=torch.zeros((2,), dtype=torch.int32)):
            pass


@pytest.mark.parametrize("adc_bits, n_dcim, chunk_block",
                         [(7, 3, None), (5, 0, None), (5, 0, 3)])
def test_fast_gemm_clip_count_equals_reference(adc_bits, n_dcim,
                                               chunk_block):
    """The chunked fast GEMM's clip count under a collector equals the
    reference fast path's (eager, so its taps see concrete values), with
    the scan block padding the chunk axis (phantom chunks never count);
    the all-analog 5-bit macro clips."""
    rng = np.random.default_rng(adc_bits)
    M, K, N = 5, 100, 7
    cfg_kw = dict(adc_bits=adc_bits, n_dcim_products=n_dcim)
    jcfg = jccim.CCIMConfig(**cfg_kw)
    tcfg = tccim.CCIMConfig(**cfg_kw)
    C = -(-K // jcfg.acc_len)
    x = rng.integers(-127, 128, (M, C, jcfg.acc_len)).astype(np.int32)
    w = rng.integers(-127, 128, (C, jcfg.acc_len, N)).astype(np.int32)
    wf, w_pl = jccim.fast_gemm_weight_ops(jnp.asarray(w), jcfg)
    with jtaps.collect() as jf:
        want_y = jccim.hybrid_mac_fast_gemm_prepacked(
            jnp.asarray(x), wf, w_pl, None, jcfg, chunk_block=chunk_block)
        want = int(jtaps.drain_sum(jf, "adc_clip"))
    buf = torch.zeros((1,), dtype=torch.int32)
    with taps.collect(adc_clip=buf):
        got_y = tccim.hybrid_mac_fast_gemm(torch.from_numpy(x),
                                           torch.from_numpy(w), None, tcfg)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    assert int(buf) == want
    if adc_bits == 5:
        assert want > 0


# ---------------------------------------------------------------------------
# host half: the registry and its exposition
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$")


def _fill(reg):
    reg.counter("req_total", "requests", {"tenant": "a"}).inc(3)
    reg.counter("req_total", "requests", {"tenant": 'b"q\\'}).inc()
    reg.gauge("occ", "occupancy").set(0.25)
    reg.gauge("nan_gauge").set(float("nan"))
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe_many([0.05, 0.5, 2.0, 0.1])
    return reg


def test_registry_exports_equal_reference():
    got, want = _fill(MetricsRegistry()), _fill(JRegistry())
    assert got.export_prometheus() == want.export_prometheus()
    # (a NaN gauge: compared as its JSON text, NaN != NaN)
    assert json.dumps(got.snapshot()) == json.dumps(want.snapshot())
    h, jh = got.histogram("lat_seconds"), want.histogram("lat_seconds")
    for q in (0.0, 0.5, 0.9, 1.0):
        assert h.quantile(q) == jh.quantile(q)


def test_registry_rules():
    reg = MetricsRegistry()
    c = reg.counter("c_total")
    assert reg.counter("c_total") is c            # create-or-get
    with pytest.raises(ValueError):
        c.inc(-1)                                  # counters are monotone
    with pytest.raises(TypeError):
        reg.gauge("c_total")                       # one kind per name
    with pytest.raises(ValueError):
        reg.counter("bad name")
    with pytest.raises(ValueError):
        reg.counter("ok", labels={"bad-label": "x"})
    with pytest.raises(ValueError):
        reg.histogram("h", buckets=())
    assert reg.histogram("empty").quantile(0.5) != \
        reg.histogram("empty").quantile(0.5)       # NaN when empty
    reg.clear()
    assert reg.export_prometheus() == "" and reg.snapshot() == {}


def test_prometheus_exposition_parses(models):
    _, _, tp, tcfg, _ = models
    sched = TS.ContinuousBatchingScheduler(tp, tcfg, slots=SLOTS,
                                           prompt_len=P, max_new_cap=CAP,
                                           obs=ObsConfig())
    snap = sched.run(_requests()).obs
    reg = MetricsRegistry()
    snap.register(reg)
    text = reg.export_prometheus()
    assert text.endswith("\n")
    typed = set()
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split()
            assert kind in ("counter", "gauge", "histogram")
            typed.add(name)
        elif not line.startswith("#"):
            assert _SAMPLE_RE.match(line), f"unparseable sample: {line!r}"
    assert {"serve_tokens_total", "serve_ttft_seconds",
            "serve_occupancy", "serve_adc_clip_total"} <= typed
    h = reg.histogram("serve_ttft_seconds")
    cum = np.cumsum(h.counts)
    assert (np.diff(cum) >= 0).all()
    assert cum[-1] == h.count == len(snap.ttft_iters)
    js = reg.snapshot()
    assert js["serve_tokens_total"][0]["value"] == snap.counters["tokens"]


def test_harvest_empty_workload_is_nan_safe():
    cfg = ObsConfig()
    snap = R.harvest_obs(cfg, R.init_obs_state(cfg), n_iter=0, wall_s=0.0,
                         slots=2, n_steps=0)
    want = JR.harvest_obs(JObs(), jax.device_get(JR.init_obs_state(JObs())),
                          n_iter=0, wall_s=0.0, slots=2, n_steps=0)
    assert snap.counters["tokens"] == 0 and snap.ttft_iters == {}
    d = snap.to_dict()
    json.dumps(d)
    assert d == want.to_dict()
    assert d["ttft_p50_iters"] is None and d["occupancy_mean"] is None
    reg = MetricsRegistry()
    snap.register(reg)
    text = reg.export_prometheus()
    assert "serve_occupancy" not in text
    assert "serve_stall_factor_iters" not in text
    assert reg.histogram("serve_ttft_seconds").count == 0


def test_harvest_fully_dropped_event_ring():
    cfg = ObsConfig(event_cap=2)
    obs = R.init_obs_state(cfg)
    for rid in range(4):
        R.ring_push(obs, R.EV_ADMIT, rid, rid)
    snap = R.harvest_obs(cfg, obs, n_iter=4, wall_s=0.1, slots=2, n_steps=4)
    assert snap.dropped_events == 2
    assert snap.ttft_iters == {}
    assert all(s["first_iter"] is None for s in snap.spans)
    d = snap.to_dict()
    json.dumps(d)
    assert d["ttft_p95_iters"] is None
    reg = MetricsRegistry()
    snap.register(reg)
    assert "NaN" not in reg.export_prometheus()
