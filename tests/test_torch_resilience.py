"""Port parity: the resilience stack (``repro_torch/resilience``) against
the reference's ``repro/resilience``, on the minicpm-2b smoke model with
packed CIM weights from the reference ``lm.init`` through
``convert.params_from_jax``.

  fault model   ``prng.bernoulli`` and the crc32 fault tags, ``parse``,
                every severity schedule at clocks 0-80 (an int clock
                against the reference's eager severity, a tensor clock
                against its jitted one), the column patterns, the stuck
                masks and faulted ``wq()`` of every packed leaf, the
                fault-armed fast GEMM against the jitted reference at
                clocks 0, 12 and 64 (and where the reference's eager and
                jitted forms agree, against the eager one: XLA's fused
                multiply-adds and reciprocal constants are the port's
                target), the exact fidelity's immunity, and the off path:
                arming and disarming leaves every branch's op sequence
                unchanged, a fault-on run differs;
  watchdog      the scripted histories, a hypothesis-driven sequence
                against the reference's ``Watchdog``, clean telemetry
                snapshots GREEN;
  ladder        pack compatibility; the clean guarded run (contiguous,
                paged, speculative) GREEN with no action and tokens equal
                to the port's plain scheduler and the reference's
                ``GuardedServer``; graphs captured up front change nothing;
                the chaos run's ``ResilienceLog.to_dict()`` equal to the
                reference's (``serve_guarded`` and the bench twin:
                ``test_torch_resilience_bench.py``).

Every comparison is ``==`` but ``probe_ratio``, held at rtol 1e-4: the
port's ``rel_rms`` sums its float32 norms in torch's order, not XLA's
(ROADMAP Queue 3 item 5).  Each reference scheduler or server runs once
per module (fixtures).
"""
import copy
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # [test] extra absent: fixed-grid fallback
    from _prop_fallback import given, settings, st

from repro.configs import get_config as jget
from repro.core.ccim import DEFAULT_CONFIG as JD
from repro.core.engine import packed_cim_matmul_int as jmm
from repro.launch import scheduler as JS
from repro.launch.paging import PagedLayout as JLayout
from repro.models import lm as jlm
from repro.plan.plan import DeploymentPlan as JPlan, PlanEntry as JEntry
from repro.resilience import faults as JF
from repro.resilience import failover as JFO
from repro.resilience import watchdog as JW
from repro_torch.configs import get_config as tget
from repro_torch.convert import packed_from_jax, params_from_jax, plan_from_jax
from repro_torch.core import prng
from repro_torch.core.ccim import DEFAULT_CONFIG as TD
from repro_torch.core.engine import (FusedPackedCimWeights, PackedCimWeights,
                                     pack_compatible, packed_cim_matmul_int)
from repro_torch.launch import graphs as G
from repro_torch.launch import scheduler as TS
from repro_torch.launch.paging import PagedLayout as TLayout
from repro_torch.models import lm as tlm
from repro_torch.obs import ObsConfig, scheduler_fingerprint
from repro_torch.resilience import faults as TF
from repro_torch.resilience import failover as TFO
from repro_torch.resilience import watchdog as TW

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

P, CAP = 8, 4
STOPS = (2, 4, 3, 4)
# the reference tests' and the bench's chaos scenario
DRIFT = dict(seed=3, gain_amp=0.6, offset_lsb=2.0, schedule="ramp",
             onset=4, period=16)
# every epilogue term live, a period whose reciprocal is inexact
HOT = dict(seed=5, gain_amp=0.3, offset_lsb=1.5, adc_offset_lsb=0.7,
           adc_clip_bits=1.3, schedule="ramp", onset=2, period=12)
SCHEDULES = [dict(schedule="step", onset=4),
             dict(schedule="ramp", onset=4, period=8),
             dict(schedule="ramp", onset=3, period=12),
             dict(schedule="ramp", onset=0, period=7),
             dict(schedule="burst", onset=0, period=8, duty=0.5),
             dict(schedule="burst", onset=5, period=10, duty=0.3)]


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


def _requests(stops=STOPS):
    return TS.mixed_length_requests(4, P, 512, stop_lengths=stops)


def _jreqs(reqs):
    return [JS.Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens,
                       stop_token=r.stop_token) for r in reqs]


def _variant(name):
    """(reference kwargs, port kwargs) of a pool variant."""
    if name == "paged":
        return (dict(paged=JLayout(block_size=8, n_tbl=2, n_blocks=12)),
                dict(paged=TLayout(block_size=8, n_tbl=2, n_blocks=12)))
    if name == "speculative":
        return dict(draft_k=2), dict(draft_k=2)
    return {}, {}


# ---------------------------------------------------------------------------
# 1. the fault model
# ---------------------------------------------------------------------------


def test_bernoulli_equals_jax_over_2_20_draws():
    """``prng.bernoulli`` == ``jax.random.bernoulli`` over 2^20 draws per
    p, under a key folded with the w2 leaf's tag (above 2^31)."""
    tag = TF.path_tag(("layers", "mlp", "w2"))
    assert tag == 0x82CC57E6
    jk = jax.random.fold_in(jax.random.PRNGKey(11), tag)
    tk = prng.fold_in(prng.PRNGKey(11), tag)
    np.testing.assert_array_equal(tk.numpy(),
                                  np.asarray(jk).astype(np.int64))
    for p in (0.01, 0.3, 1 / 3):
        want = np.asarray(jax.random.bernoulli(jk, p, (1 << 20,)))
        got = prng.bernoulli(tk, p, (1 << 20,)).numpy()
        np.testing.assert_array_equal(got, want)


def test_fault_model_parse_equals_reference():
    spec = ("gain_amp=0.5,schedule=ramp,onset=8,period=32,"
            "stuck_frac=0.001,stuck_mode=sign,seed=7")
    assert (dataclasses.asdict(TF.FaultModel.parse(spec))
            == dataclasses.asdict(JF.FaultModel.parse(spec)))
    for bad in ("no_such_knob=1", "gain_amp"):
        with pytest.raises(ValueError) as te:
            TF.FaultModel.parse(bad)
        with pytest.raises(ValueError) as je:
            JF.FaultModel.parse(bad)
        assert str(te.value) == str(je.value)
    for kw in (dict(schedule="sinusoid"), dict(stuck_mode="x"),
               dict(stuck_frac=2.0), dict(period=0)):
        with pytest.raises(ValueError):
            TF.FaultModel(**kw)
    assert not TF.FaultModel().touches_epilogue
    assert TF.FaultModel(adc_clip_bits=1.0).touches_epilogue


@pytest.mark.parametrize("kw", SCHEDULES + [DRIFT, HOT],
                         ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_severity_equals_reference_at_clocks_0_to_80(kw):
    """An int clock equals the reference's eager severity, a tensor clock
    its jitted one (a true division there, a float32 reciprocal here)."""
    tm, jm = TF.FaultModel(**kw), JF.FaultModel(**kw)
    jit = jax.jit(jm.severity)
    for t in range(81):
        assert float(tm.severity(t)) == float(jm.severity(t)), t
        got = tm.severity(torch.tensor(t, dtype=torch.int32))
        assert float(got) == float(jit(jnp.int32(t))), t


@pytest.mark.parametrize("n", [16, 96, 257])
def test_column_patterns_equal_reference(n):
    for seed in (0, 3):
        g, o = TF.FaultModel(seed=seed).column_patterns(n)
        jg, jo = JF.FaultModel(seed=seed).column_patterns(n)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))


def _packed_leaves(tree, path=()):
    """(path, PackedCimWeights) of every packed leaf of a port tree."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _packed_leaves(v, path + (k,))
        elif isinstance(v, FusedPackedCimWeights):
            out.append((path + (k,), v.packed))
        elif isinstance(v, PackedCimWeights):
            out.append((path + (k,), v))
    return out


def _jleaf(tree, path):
    v = tree
    for k in path:
        v = v[k]
    return v.packed if hasattr(v, "seg_names") else v


@pytest.mark.parametrize("mode", ["mag_msb", "sign"])
def test_stuck_faults_every_leaf_equal_reference(models, mode):
    """The stuck masks and faulted ``wq()`` of every packed leaf (the
    four stacked leaves of the smoke model), and the re-packed kernel
    operands, equal the reference's."""
    jpk, _, tpk, _, _ = models
    kw = dict(seed=11, stuck_frac=0.01, stuck_mode=mode)
    jf = JF.apply_weight_faults(JF.FaultModel(**kw), jpk)
    tf = TF.apply_weight_faults(TF.FaultModel(**kw), tpk)
    leaves = _packed_leaves(tf)
    assert sorted("/".join(p) for p, _ in leaves) == [
        "layers/attn/wo", "layers/attn/wq+wk+wv", "layers/mlp/w1+w3",
        "layers/mlp/w2"]
    for path, leaf in leaves:
        tag = TF.path_tag(path)
        jl = _jleaf(jf, path)
        shape = tuple(leaf.wq().shape)
        mask = TF.stuck_mask(TF.FaultModel(**kw), shape, tag)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(
            JF.stuck_mask(JF.FaultModel(**kw), shape, tag)))
        np.testing.assert_array_equal(
            TF.stuck_mask(TF.FaultModel(**kw), shape, tag, layer=1).numpy(),
            mask[1].numpy())
        np.testing.assert_array_equal(leaf.wq().numpy(),
                                      np.asarray(jl.wq()))
        want = packed_from_jax(jax.tree.map(np.asarray, jl), "cpu")
        assert torch.equal(leaf.kernel_w, want.kernel_w)
        assert torch.equal(leaf.kernel_planes, want.kernel_planes)
        clean = np.asarray(_jleaf(jpk, path).wq())
        frac = np.mean(leaf.wq().numpy() != clean)
        assert 0 < frac < 0.05, (path, frac)
    assert TF.apply_weight_faults(TF.FaultModel(), tpk) is tpk


@pytest.fixture(scope="module")
def probe_leaf(models):
    jpk, _, tpk, _, _ = models
    jl, tl = JW.first_packed_leaf(jpk), TW.first_packed_leaf(tpk)
    want = packed_from_jax(jax.tree.map(np.asarray, jl), "cpu")
    assert torch.equal(tl.kernel_w, want.kernel_w)      # layer 0 of wo
    assert (tl.k_dim, tl.n_dim) == (jl.k_dim, jl.n_dim)
    return jl, tl


@pytest.mark.parametrize("kw", [DRIFT, HOT], ids=["drift", "hot"])
def test_faulted_gemm_equals_jitted_reference(probe_leaf, kw):
    """The fault-armed fast GEMM (M 4 and 37 on layer 0's ``wo``) at
    clocks 0, 12 and 64, the clock a device tensor, equals the
    reference's GEMM under ``jax.jit`` with ``==``.  Against the eager
    reference it is equal wherever the reference's eager and jitted
    results agree: where they differ, the jitted one is the target."""
    jl, tl = probe_leaf
    jm, tm = JF.FaultModel(**kw), TF.FaultModel(**kw)

    def ref(x, t):
        with JF.inject(jm), JF.clock(t):
            return jmm(x, jl, None, JD, fidelity="fast")
    jit = jax.jit(ref)
    for m in (4, 37):
        x = jax.random.randint(jax.random.PRNGKey(m), (m, jl.k_dim),
                               -127, 128, jnp.int32)
        xt = torch.from_numpy(np.array(x))
        clean = packed_cim_matmul_int(xt, tl, TD).numpy()
        for t in (0, 12, 64):
            with TF.inject(tm), TF.clock(torch.tensor(t, dtype=torch.int32)):
                got = packed_cim_matmul_int(xt, tl, TD).numpy()
            want = np.asarray(jit(x, jnp.int32(t)))
            np.testing.assert_array_equal(got, want)
            eager = np.asarray(ref(x, t))
            agree = eager == want
            np.testing.assert_array_equal(got[agree], eager[agree])
            if t == 0 and kw is DRIFT:
                np.testing.assert_array_equal(got, clean)    # pre-onset
            if t == 64:
                assert not np.array_equal(got, clean)


def test_exact_fidelity_is_immune(models, probe_leaf):
    jl, tl = probe_leaf
    x = jax.random.randint(jax.random.PRNGKey(2), (4, jl.k_dim), -127, 128,
                           jnp.int32)
    xt = torch.from_numpy(np.array(x))
    clean = packed_cim_matmul_int(xt, tl, TD, fidelity="exact")
    with TF.inject(TF.FaultModel(**DRIFT)), TF.clock(64):
        assert TF.active()
        hot = packed_cim_matmul_int(xt, tl, TD, fidelity="exact")
    assert not TF.active()
    assert torch.equal(hot, clean)
    np.testing.assert_array_equal(clean.numpy(), np.asarray(
        jmm(x, jl, None, JD, fidelity="exact")))


def test_weight_only_model_keeps_the_kernels(probe_leaf):
    """A model without epilogue terms arms nothing: ``active()`` stays
    False, so the GEMMs keep their kernels (the plain version here)."""
    _, tl = probe_leaf
    xt = torch.randint(-127, 128, (4, tl.k_dim), dtype=torch.int32)
    with TF.inject(TF.FaultModel(stuck_frac=0.1)):
        assert TF.site() is not None and not TF.active()
        y = packed_cim_matmul_int(xt, tl, TD)
    assert torch.equal(y, packed_cim_matmul_int(xt, tl, TD))


@pytest.mark.parametrize("variant", ["contiguous", "paged", "speculative"])
def test_off_path_op_sequences(models, variant):
    """Arming and disarming a model leaves the op sequence of every branch
    unchanged; a fault-on run's differs (the wiring proof)."""
    _, _, tpk, tcfg, _ = models
    _, kw = _variant(variant)

    def make():
        return TS.ContinuousBatchingScheduler(tpk, tcfg, slots=2,
                                              prompt_len=P, max_new_cap=CAP,
                                              **kw)
    before = scheduler_fingerprint(make(), 2)
    with TF.inject(TF.FaultModel(**DRIFT)):
        on = scheduler_fingerprint(make(), 2)
    after = scheduler_fingerprint(make(), 2)
    assert before == after
    assert on != before


def test_clock_writes_every_iteration(models):
    """Under an armed model the pool state's device clock holds each
    iteration's index as its branch runs, admits included."""
    _, _, tpk, tcfg, _ = models
    sched = TS.ContinuousBatchingScheduler(tpk, tcfg, slots=2, prompt_len=P,
                                           max_new_cap=CAP)
    seen = []
    st = sched._state()

    def on_branch(name):
        if name is not None:
            seen.append(int(st["fault_clock"]))
    with TF.inject(TF.FaultModel(**DRIFT)):
        rep = sched.run(_requests(), on_branch=on_branch)
    assert seen == list(range(rep.n_iter))


# ---------------------------------------------------------------------------
# 2. the watchdog
# ---------------------------------------------------------------------------


def _same(a, b) -> bool:
    """Equal as JSON text (a NaN window value equals a NaN)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _both(cfg_kw, calls):
    """The port's and the reference's watchdog fed the same windows."""
    t = TW.Watchdog(TW.WatchdogConfig(**cfg_kw), baseline_clip_rate=0.01)
    j = JW.Watchdog(JW.WatchdogConfig(**cfg_kw), baseline_clip_rate=0.01)
    states = [(t.observe(**c), j.observe(**c)) for c in calls]
    return t, j, states


def test_watchdog_scripted_histories_equal_reference():
    ob = lambda **k: dict(n_tokens=0, n_iter=0, **k)
    scripts = [
        (dict(debounce=2, recover=2), [ob(clip_rate=c) for c in
                                       (0.0, 9.9, 0.0, 9.9, 9.9)]),
        (dict(debounce=1, recover=2), [ob(clip_rate=c) for c in
                                       (9.9, 0.0, 0.0, 0.0, 0.0)]),
        (dict(debounce=1), [ob(probe_ratio=1.0), ob(probe_ratio=50.0)]),
        (dict(debounce=1), [ob(accept_rate=0.9), ob(accept_rate=0.1)]),
        (dict(debounce=3), [ob(clip_rate=0.1), ob(clip_rate=0.9),
                            ob(probe_ratio=4.0), ob(accept_rate=float("nan"))]),
    ]
    want_states = [["GREEN", "GREEN", "GREEN", "GREEN", "RED"],
                   ["RED", "RED", "AMBER", "AMBER", "GREEN"],
                   ["GREEN", "RED"], ["GREEN", "RED"], None]
    for (kw, calls), want in zip(scripts, want_states):
        t, j, states = _both(kw, calls)
        assert [a for a, _ in states] == [b for _, b in states]
        if want is not None:
            assert [a for a, _ in states] == want
        assert _same(t.to_dict(), j.to_dict())
        det_t, det_j = t.detection, j.detection
        assert (det_t is None) == (det_j is None)
        if det_t is not None:
            assert _same(det_t.to_dict(), det_j.to_dict())
    with pytest.raises(ValueError):
        TW.WatchdogConfig(debounce=0)


@settings(deadline=None, max_examples=40, database=None)
@given(st.integers(min_value=0, max_value=2**31 - 1))
def test_watchdog_random_sequences_equal_reference(seed):
    """Random windows (clip, acceptance and probe signals, some missing
    or NaN) under a random debounce/recover: the port's history equals
    the reference's window for window."""
    rng = np.random.default_rng(seed)
    kw = dict(debounce=int(rng.integers(1, 4)), recover=int(rng.integers(1, 5)))
    calls = []
    for i in range(int(rng.integers(1, 30))):
        pick = lambda lo, hi: (None if rng.random() < 0.3 else
                               float("nan") if rng.random() < 0.05 else
                               float(rng.uniform(lo, hi)))
        calls.append(dict(n_tokens=i * 3, n_iter=i, clip_rate=pick(0, 1),
                          accept_rate=pick(0, 1), probe_ratio=pick(0, 15)))
    t, j, states = _both(kw, calls)
    assert [a for a, _ in states] == [b for _, b in states]
    assert _same(t.to_dict(), j.to_dict())


@pytest.mark.parametrize("variant", ["contiguous", "paged", "speculative"])
def test_watchdog_clean_snapshots_green(models, variant):
    _, _, tpk, tcfg, _ = models
    _, kw = _variant(variant)
    sched = TS.ContinuousBatchingScheduler(tpk, tcfg, slots=2, prompt_len=P,
                                           max_new_cap=CAP, obs=ObsConfig(),
                                           **kw)
    wd = TW.Watchdog()
    assert wd.observe_snapshot(sched.run(_requests()).obs) == TW.GREEN


def test_probe_equals_reference(models, probe_leaf):
    """The golden probe's draw, exact reference, clean floor and ratios
    under the drift at clocks 0, 12 and 64."""
    jpk, _, tpk, _, _ = models
    jl, tl = probe_leaf
    jp = JW.GoldenProbe(jl, fault=JF.FaultModel(**DRIFT))
    tp = TW.GoldenProbe(tl, fault=TF.FaultModel(**DRIFT))
    np.testing.assert_array_equal(tp.xq.numpy(), np.asarray(jp.xq))
    np.testing.assert_array_equal(tp.ref.numpy(), jp.ref)
    np.testing.assert_allclose(tp.clean_floor, jp.clean_floor, rtol=1e-4)
    for t in (0, 12, 64):
        np.testing.assert_allclose(tp(t), jp(t), rtol=1e-4)
    assert TFO.default_probe({"embed": torch.zeros(2)}) is None


# ---------------------------------------------------------------------------
# 3. the ladder and the guarded server
# ---------------------------------------------------------------------------


def test_ladder_pack_compatible_and_equal_reference():
    base = JEntry(cfg=JD, fidelity="fast")
    jplan = JPlan.uniform(base)
    tplan = plan_from_jax(jplan)
    for spec in (False, True):
        jr, js = JFO.derive_ladder(jplan, speculative=spec)
        tr, ts = TFO.derive_ladder(tplan, speculative=spec)
        assert ts == js and [r.label for r in tr] == [r.label for r in jr]
        for a, b in zip(tr, jr):
            assert a.plan == plan_from_jax(b.plan)
            assert (a.draft_plan is None) == (b.draft_plan is None)
            if a.draft_plan is not None:
                assert a.draft_plan == plan_from_jax(b.draft_plan)
            for plans in (a.plan, a.draft_plan):
                if plans is None:
                    continue
                for _, e in list(plans.entries) + [(None, plans.default)]:
                    if e.fidelity != "float":
                        assert pack_compatible(TD, e.cfg)
    dig = TFO.derive_exact_plan(tplan)
    assert dig.default.fidelity == "exact" and dig.default.cfg == TD


@pytest.fixture(scope="module")
def reference_clean(models):
    """The reference's clean guarded runs, one per variant."""
    jpk, jcfg, _, _, _ = models
    out = {}
    for name in ("contiguous", "paged", "speculative"):
        jkw, _ = _variant(name)
        server = JFO.GuardedServer(
            jpk, jcfg, slots=2, prompt_len=P, max_new_cap=CAP,
            watchdog=JW.Watchdog(), probe=JFO.default_probe(jpk),
            segment_iters=4, **jkw)
        rep, log = server.run(_jreqs(_requests()))
        out[name] = (rep.tokens_by_rid(), log.to_dict())
    return out


def _assert_log_equal(got, want):
    """``ResilienceLog.to_dict()`` equality, the probe ratios at rtol
    1e-4 (float32 norm sums in another order)."""
    got, want = copy.deepcopy(got), copy.deepcopy(want)
    gw, ww = got.pop("watchdog"), want.pop("watchdog")
    assert got == want
    assert (gw is None) == (ww is None)
    if gw is None:
        return
    gwin, wwin = gw.pop("windows"), ww.pop("windows")
    assert gw == ww and len(gwin) == len(wwin)
    for a, b in zip(gwin, wwin):
        pa, pb = a.pop("probe_ratio"), b.pop("probe_ratio")
        assert (pa is None) == (pb is None)
        if pa is not None:
            np.testing.assert_allclose(pa, pb, rtol=1e-4)
        assert a == b


@pytest.mark.parametrize("variant", ["contiguous", "paged", "speculative"])
def test_clean_guarded_green_and_token_parity(models, reference_clean,
                                              variant):
    _, _, tpk, tcfg, _ = models
    _, kw = _variant(variant)
    server = TFO.GuardedServer(
        tpk, tcfg, slots=2, prompt_len=P, max_new_cap=CAP,
        watchdog=TW.Watchdog(), probe=TFO.default_probe(tpk),
        segment_iters=4, **kw)
    reqs = _requests()
    report, log = server.run(reqs)
    assert server.watchdog.state == TW.GREEN and log.actions == []
    assert log.n_compiles == len(server.ladder)
    plain = TS.ContinuousBatchingScheduler(
        tpk, tcfg, slots=2, prompt_len=P, max_new_cap=CAP,
        **kw).run(reqs)
    got, want = report.tokens_by_rid(), plain.tokens_by_rid()
    jtoks, jlog = reference_clean[variant]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        np.testing.assert_array_equal(got[rid], jtoks[rid])
    assert report.n_iter == plain.n_iter
    assert report.host_syncs == plain.host_syncs
    _assert_log_equal(log.to_dict(), jlog)


@pytest.fixture(scope="module")
def reference_chaos(models):
    jpk, jcfg, _, _, _ = models
    fault = JF.FaultModel(**DRIFT)
    server = JFO.GuardedServer(
        jpk, jcfg, slots=2, prompt_len=P, max_new_cap=16, fault=fault,
        watchdog=JW.Watchdog(JW.WatchdogConfig(debounce=1)),
        probe=JFO.default_probe(jpk, fault=fault), segment_iters=4)
    rep, log = server.run(_jreqs(_requests((4, 16, 8, 12))))
    return rep.tokens_by_rid(), log.to_dict()


def _chaos_run(tpk, tcfg):
    fault = TF.FaultModel(**DRIFT)
    server = TFO.GuardedServer(
        tpk, tcfg, slots=2, prompt_len=P, max_new_cap=16, fault=fault,
        watchdog=TW.Watchdog(TW.WatchdogConfig(debounce=1)),
        probe=TFO.default_probe(tpk, fault=fault), segment_iters=4)
    rep, log = server.run(_requests((4, 16, 8, 12)))
    return server, rep, log


def test_chaos_log_equals_reference(models, reference_chaos):
    """The seeded drift: RED within 32 tokens, escalation to the digital
    rung, nothing prepared mid-run; the log equals the reference's and
    two independently built servers agree; tokens equal too."""
    _, _, tpk, tcfg, _ = models
    s1, rep1, log1 = _chaos_run(tpk, tcfg)
    _, _, log2 = _chaos_run(tpk, tcfg)
    assert s1.watchdog.state == TW.RED
    assert log1.detection_tokens is not None
    assert log1.detection_tokens <= 32
    assert log1.final_rung == len(s1.ladder) - 1
    assert log1.actions and log1.n_compiles == len(s1.ladder)
    assert log1.to_dict() == log2.to_dict()
    jtoks, jlog = reference_chaos
    _assert_log_equal(log1.to_dict(), jlog)
    got = rep1.tokens_by_rid()
    for rid in jtoks:
        np.testing.assert_array_equal(got[rid], jtoks[rid])


def test_guarded_validation(models):
    _, _, tpk, tcfg, _ = models
    with pytest.raises(ValueError):
        TFO.GuardedServer(tpk, tcfg, slots=2, prompt_len=P, max_new_cap=CAP,
                          start_rung=7)
    with pytest.raises(ValueError):
        TFO.GuardedServer(tpk, tcfg, slots=2, prompt_len=P, max_new_cap=CAP,
                          segment_iters=0)
    a = TS.ContinuousBatchingScheduler(tpk, tcfg, slots=2, prompt_len=P,
                                       max_new_cap=CAP)
    b = TS.ContinuousBatchingScheduler(tpk, tcfg, slots=3, prompt_len=P,
                                       max_new_cap=CAP)
    with pytest.raises(ValueError):
        b.share_state(a)


class _RerunGraph(G.StepGraph):
    """No CUDA: the warm-up runs the body, the capture runs nothing, and a
    replay runs the body again (``tests/test_torch_graphs.py``'s)."""

    def _warm(self):
        return self.body()

    def _record(self):
        def replay():
            self.outputs = self.body()
        return types.SimpleNamespace(replay=replay), None


@pytest.fixture
def rerun_graphs(monkeypatch):
    monkeypatch.setattr(TS, "StepGraph", _RerunGraph)
    monkeypatch.setattr(TS, "use_graphs", lambda graphs, dev: True)


@pytest.mark.parametrize("variant", ["contiguous", "paged", "speculative"])
def test_capture_up_front_changes_nothing(models, rerun_graphs, variant):
    """``compile_for`` captures every rung's graphs on the shared, empty
    pool state (each capture's first call a real step there): the guarded
    run afterwards gives the tokens, counters and rings of the plain
    run, captures nothing more, and a model armed differently from the
    captures raises."""
    _, _, tpk, tcfg, _ = models
    _, kw = _variant(variant)
    server = TFO.GuardedServer(tpk, tcfg, slots=2, prompt_len=P,
                               max_new_cap=CAP, segment_iters=3, **kw)
    reqs = _requests()
    server.compile_for(len(reqs))
    # per rung: the step (or round) graph, and a chunk graph per slot
    per_rung = 1 + (2 if variant == "paged" else 0)
    assert server.captures() == len(server.ladder) * per_rung
    report, log = server.run(reqs)
    assert log.n_compiles == len(server.ladder)
    plain = TS.ContinuousBatchingScheduler(
        tpk, tcfg, slots=2, prompt_len=P, max_new_cap=CAP, obs=ObsConfig(),
        graphs=False, **kw).run(reqs)
    for rid, toks in plain.tokens_by_rid().items():
        np.testing.assert_array_equal(report.tokens_by_rid()[rid], toks)
    assert report.obs.counters == plain.obs.counters
    assert report.obs.events == plain.obs.events
    for k, v in plain.obs.iter_samples.items():
        np.testing.assert_array_equal(report.obs.iter_samples[k], v)
    with TF.inject(TF.FaultModel(**DRIFT)):
        with pytest.raises(RuntimeError):
            server.scheduler().run(reqs)
