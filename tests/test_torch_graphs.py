"""The serving drivers' captured step bodies (``launch/graphs.py``) on the
CPU: the in-place bodies against the reference, the scheduler's state
reset in place, the launch accounting of a captured graph, the rope
tables a graph holds, and the guard that keeps graphs on CUDA devices.

A CUDA graph cannot be captured here, so two stand-ins take its place:

  ``_StubGraph``    counts what a capture and a replay do to the launch
                    counters (a capture ticks them, a replay runs
                    nothing in Python);
  ``_RerunGraph``   replays by running the body again, which is what a
                    replay does to the state; it shows that the drivers
                    route every step after the first through the graph
                    and that the state it reads persists between steps.

The drivers' tokens must equal the reference's (greedy, minicpm-2b smoke,
packed CIM weights taken from the reference ``lm.init`` through numpy)
eagerly and through ``_RerunGraph``: lock-step, speculative at draft ADC
8 and 5, and the scheduler contiguous and paged.  Each reference run
happens once per module (a fixture).  The card's own captured runs are
in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phases 25-27.
"""
import dataclasses
import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import scheduler as JS
from repro.launch.paging import PagedLayout as JLayout
from repro.launch.serve import serve as jserve
from repro.launch.serve import serve_speculative as jspec
from repro.models import lm as jlm
from repro.plan import draft_plan_for_model as jdraft
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ccim_complex import kernel as CK
from repro_torch.kernels.ccim_matmul import kernel as K
from repro_torch.kernels.int8_matmul import kernel as IK
from repro_torch.kernels.paged_attn import kernel as PK
from repro_torch.launch import graphs as G
from repro_torch.launch import scheduler as TS
from repro_torch.launch import serve as TSV
from repro_torch.launch.paging import PagedLayout as TLayout
from repro_torch.models import layers as L
from repro_torch.models import lm as tlm
from repro_torch.plan import draft_plan_for_model as tdraft

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

B, P, GEN, DRAFT_K = 2, 8, 10, 4          # lock-step and speculative serve
SLOTS, CAP, SCHED_K, ADC = 2, 6, 4, 5     # the scheduler
LAYOUT, CHUNK = (4, 6, 24), 4             # block size, table width, blocks


class _StubGraph(G.StepGraph):
    """No CUDA: the warm-up and the capture each run the body once (a
    capture's Python runs, and its counters tick), a replay runs
    nothing."""

    def _warm(self):
        return self.body()

    def _record(self):
        return types.SimpleNamespace(replay=lambda: None), self.body()


class _RerunGraph(G.StepGraph):
    """No CUDA: the warm-up runs the body, the capture runs nothing, and
    a replay runs the body again and returns what it returned."""

    def _warm(self):
        return self.body()

    def _record(self):
        def replay():
            self.outputs = self.body()
        return types.SimpleNamespace(replay=replay), None


@pytest.fixture
def rerun_graphs(monkeypatch):
    """The drivers replay ``_RerunGraph``s on the CPU."""
    for mod in (TSV, TS):
        monkeypatch.setattr(mod, "StepGraph", _RerunGraph)
        monkeypatch.setattr(mod, "use_graphs", lambda graphs, dev: True)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tcfg, "cpu")
    return jp, jcfg, tp, tcfg


def _requests(paged: bool):
    if paged:
        return TS.shared_prefix_requests(4, 4, 3, P, 512,
                                         stop_lengths=(2, CAP, 3), seed=2)
    return TS.mixed_length_requests(4, P, 512, stop_lengths=(2, CAP, 3),
                                    seed=1)


def _sched_kw(paged: bool, layout):
    kw = dict(slots=SLOTS, prompt_len=P, max_new_cap=CAP)
    if paged:
        kw.update(paged=layout(*LAYOUT), prefill_chunk=CHUNK)
    return kw


CASES = ("lockstep", "spec_adc8", "spec_adc5", "sched_contiguous",
         "sched_paged")


@pytest.fixture(scope="module", params=CASES)
def reference(request, models):
    """(case, the reference's tokens) -- its own serve at seed 0, or its
    scheduler on the case's queue."""
    jp, jcfg, _, _ = models
    case = request.param
    if case == "lockstep":
        return case, np.asarray(jserve("minicpm-2b", smoke=True, batch=B,
                                       prompt_len=P, gen=GEN, cim=True))
    if case.startswith("spec"):
        toks, st = jspec("minicpm-2b", smoke=True, batch=B, prompt_len=P,
                         gen=GEN, draft_k=DRAFT_K,
                         draft_adc_bits=int(case[-1]), return_stats=True,
                         compare_baseline=False)
        return case, (np.asarray(toks), st)
    paged = case == "sched_paged"
    reqs = [JS.Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens)
            for r in _requests(paged)]
    rep = JS.ContinuousBatchingScheduler(
        jlm.pack_cim_params(jp, jcfg), jcfg,
        **_sched_kw(paged, JLayout)).run(reqs)
    return case, rep.tokens_by_rid()


def _port(case, tp, tcfg, graphs):
    """The port's tokens for ``case`` (and its stats or report)."""
    if case == "lockstep":
        return TSV.serve("minicpm-2b", smoke=True, batch=B, prompt_len=P,
                         gen=GEN, cim=True, device="cpu", params=tp,
                         graphs=graphs, return_stats=True)
    if case.startswith("spec"):
        return TSV.serve_speculative(
            "minicpm-2b", smoke=True, batch=B, prompt_len=P, gen=GEN,
            draft_k=DRAFT_K, draft_adc_bits=int(case[-1]), device="cpu",
            params=tp, graphs=graphs, return_stats=True)
    paged = case == "sched_paged"
    sched = TS.ContinuousBatchingScheduler(
        tlm.pack_cim_params(tp, tcfg, "cpu"), tcfg,
        **_sched_kw(paged, TLayout), graphs=graphs)
    rep = sched.run(_requests(paged))
    return rep.tokens_by_rid(), (sched, rep)


def _assert_same(case, got, want):
    if case.startswith("sched"):
        assert sorted(got) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                          err_msg=f"{case} request {rid}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=case)


@pytest.mark.parametrize("replay", ["eager", "rerun_graph"])
def test_in_place_bodies_equal_reference(request, models, reference, replay):
    """The drivers' in-place step bodies serve the reference's tokens,
    eagerly and with every step after the first replayed."""
    _, _, tp, tcfg = models
    case, want = reference
    if replay == "rerun_graph":
        request.getfixturevalue("rerun_graphs")
    got, info = _port(case, tp, tcfg, graphs=None)
    if case.startswith("spec"):
        want, wstats = want
        for key in ("n_rounds", "n_drafted", "n_accepted"):
            assert info[key] == wstats[key], key
    _assert_same(case, got, want)
    if replay == "eager":
        assert (info["graphs"] if isinstance(info, dict)
                else info[0].graphs) is False
        return
    if case == "lockstep":            # one eager step, GEN - 2 replays
        assert info["graphs"] and "replay_tok_s" in info
    elif case.startswith("spec"):
        assert info["graphs"] and info["n_rounds"] >= 2
    else:
        sched, rep = info
        stats = sched.graph_stats()
        assert stats["step"]["replays"] == rep.n_steps - 1
        # the state and the graph outlive a run: a second run replays
        again = sched.run(_requests(case == "sched_paged"))
        _assert_same(case, again.tokens_by_rid(), want)
        assert sched.graph_stats()["step"]["replays"] == (
            rep.n_steps - 1 + again.n_steps)


def test_speculative_scheduler_rungs_replay(models, rerun_graphs):
    """The adaptive speculative pool keeps one graph per rung it visits;
    every round after a rung's first replays, and the pool's tokens equal
    the non-speculative pool's.  The graphs do not keep their scheduler
    (its weights, cache and pools) alive: dropping it frees it."""
    _, _, tp, tcfg = models
    packed = tlm.pack_cim_params(tp, tcfg, "cpu")
    reqs = _requests(False)
    want = TS.ContinuousBatchingScheduler(
        packed, tcfg, **_sched_kw(False, TLayout),
        graphs=False).run(reqs).tokens_by_rid()
    sched = TS.ContinuousBatchingScheduler(
        packed, tcfg, **_sched_kw(False, TLayout), draft_k=SCHED_K,
        draft_plan=tdraft(tcfg, ADC), adaptive_draft_k=True)
    rep = sched.run(reqs)
    _assert_same("sched", rep.tokens_by_rid(), want)
    stats = sched.graph_stats()
    assert stats and set(stats) <= {f"round_k{k}" for k in sched._rungs}
    assert sum(s["replays"] + 1 for s in stats.values()) == rep.n_steps
    gc.disable()
    try:
        ref = weakref.ref(sched)
        del sched
        assert ref() is None
    finally:
        gc.enable()


def _ptrs(tree):
    return {k: _ptrs(v) if isinstance(v, dict) else v.data_ptr()
            for k, v in tree.items()}


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_step_bodies_keep_their_state_in_place(models, paged):
    """A captured body reads and writes fixed storage: after the pooled
    step and a speculative round, every tensor of the pool state is the
    one it was (and ``decode_step`` returns its cache)."""
    _, _, tp, tcfg = models
    sched = TS.ContinuousBatchingScheduler(
        tlm.pack_cim_params(tp, tcfg, "cpu"), tcfg,
        **_sched_kw(paged, TLayout), draft_k=2,
        draft_plan=tdraft(tcfg, ADC))
    sched.run(_requests(paged))
    st = sched._st
    before = _ptrs(st)
    with torch.inference_mode():
        if not paged:
            sched._arm_slot(st, 0, torch.tensor([list(range(1, P + 1))]),
                            CAP, -1)
        sched._step(st)
        sched._spec_step(st, 2)
        _, cache = tlm.decode_step(sched._params, tcfg, st["last_tok"],
                                   st["cache"], live=st["live"])
    assert cache is st["cache"]
    assert _ptrs(st) == before


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_state_resets_in_place(models, paged):
    """A run starts from the state a new scheduler starts from, written
    into the tensors of the run before (the graphs read those)."""
    _, _, tp, tcfg = models
    packed = tlm.pack_cim_params(tp, tcfg, "cpu")
    kw = dict(_sched_kw(paged, TLayout), draft_k=2,
              draft_plan=tdraft(tcfg, ADC), graphs=False)
    sched = TS.ContinuousBatchingScheduler(packed, tcfg, **kw)
    sched.run(_requests(paged))
    before = _ptrs(sched._st)
    with torch.inference_mode():
        st = sched._state()
        fresh = TS.ContinuousBatchingScheduler(packed, tcfg, **kw)._state()
    assert st is sched._st and _ptrs(st) == before

    def flat(tree):
        return {k: v for key, t in tree.items()
                for k, v in (flat(t).items() if isinstance(t, dict)
                             else [(key, t)])}
    got, want = flat(st), flat(fresh)
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        assert t.dtype == got[key].dtype and torch.equal(t, got[key]), key
    if paged:
        assert int(st["ref"][0]) == 1                     # the trash pin


def test_graph_holds_the_rope_tables_it_reads():
    """A captured body's rope tables stay alive with the graph after their
    bounded cache drops them; outside a capture nothing is held."""
    x = torch.ones((1, 2, 1, 8))
    pos = torch.tensor([[0, 5]])
    n_pos = 4099                                # a table no other test asks
    g = _StubGraph(lambda: L.rope(x, pos, 1e4, n_pos), "cpu")
    g()
    key = (n_pos, 4, 1e4, "cpu")
    held = g._held[key]
    assert list(g._held) == [key] and held is L._rope_table(*key)
    L._rope_table.cache_clear()
    assert L._rope_table.cache_info().maxsize == 16
    assert g._held[key] is held and held[0].shape == (n_pos, 4)
    L.rope(x, pos, 1e4, n_pos)
    assert not L._HOLDERS and list(g._held) == [key]


def test_graph_holds_the_noise_keys_it_reads():
    """A captured body's analog-noise keys stay alive with the graph after
    their bounded cache drops them; outside a capture nothing is held."""
    cfg = types.SimpleNamespace(cim_noise_seed=12345)
    path = "mlp/w1"
    g = _StubGraph(lambda: L._dense_noise_key(cfg, path, "cpu"), "cpu")
    g()
    key = ("noise_key", 12345, path, torch.device("cpu"))
    held = g._held[key]
    assert list(g._held) == [key]
    assert held is L._noise_key(12345, path, torch.device("cpu"))
    L._noise_key.cache_clear()
    assert L._noise_key.cache_info().maxsize == 64
    assert g._held[key] is held and held.shape == (2,)
    L._dense_noise_key(cfg, path, "cpu")
    assert not L._HOLDERS and list(g._held) == [key]


def test_launch_accounting_on_a_stub_graph():
    """A capture's ticks are undone and each replay credits the captured
    launches; the first call is a real step and counts as one."""
    def counter(name, n=0):
        f = lambda: None                                   # noqa: E731
        f.__name__, f.launches = name, n
        return f

    a, b, idle = counter("a", 5), counter("b"), counter("idle")
    runs = []

    def body():
        runs.append(len(runs))
        a.launches += 2
        b.launches += 3
        return f"run {len(runs)}"

    g = _StubGraph(body, "cpu", counters=(a, b, idle))
    assert g() == "run 1"                        # the eager first step
    assert (a.launches, b.launches, idle.launches) == (7, 3, 0)
    assert g.launches == {"a": 2, "b": 3} and len(runs) == 2
    for i in range(1, 4):
        assert g() == "run 2"                    # the captured outputs
        assert (a.launches, b.launches, idle.launches) == (7 + 2 * i,
                                                           3 + 3 * i, 0)
    assert g.replays == 3 and len(runs) == 2


def test_kernel_wrappers_are_every_counter():
    """The graphs credit every wrapper that counts launches."""
    found = {f for mod in (K, CK, IK, PK) for f in vars(mod).values()
             if callable(f) and hasattr(f, "launches")}
    assert set(G.kernel_wrappers()) == found and len(found) == 8


@pytest.mark.parametrize("driver", ["serve", "serve_speculative",
                                    "serve_continuous", "scheduler"])
def test_graphs_on_a_cpu_device_raise(models, driver):
    _, _, tp, tcfg = models
    kw = dict(smoke=True, device="cpu", params=tp, graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        if driver == "scheduler":
            TS.ContinuousBatchingScheduler(tp, tcfg, slots=2, prompt_len=4,
                                           max_new_cap=4, graphs=True)
        else:
            getattr(TSV, driver)("minicpm-2b", **kw)
    assert G.use_graphs(None, torch.device("cpu")) is False
    assert G.use_graphs(False, torch.device("cpu")) is False
