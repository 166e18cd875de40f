"""Port parity: temperature sampling on every serving path.

The port draws from ``core/prng.py``, the reference's threefry streams
bit for bit, in the reference's order, so its sampled tokens must equal
the reference's with ``==`` (minicpm-2b smoke, packed CIM weights taken
from the reference ``lm.init`` through numpy): lock-step ``serve`` at T
0.7 and 8.0 (the first token sampled too), ``serve_speculative`` at T
0.7 (rejection sampling against a clipping draft, with its round
counts), and the scheduler contiguous, paged and speculative at T 0.7,
eagerly and with every step after the first replayed (``_RerunGraph``,
as in tests/test_torch_graphs.py).  The port's own pools equal solo
runs at T 0.7, the counterpart of the reference's
``test_temperature_pool_matches_solo``.  Each reference run happens once
per module (a fixture).
"""
import dataclasses
import types

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
from repro_torch.launch import graphs as G
from repro_torch.launch import scheduler as TS
from repro_torch.launch import serve as TSV
from repro_torch.launch.paging import PagedLayout as TLayout
from repro_torch.models import lm as tlm
from repro_torch.plan import draft_plan_for_model as tdraft

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

T = 0.7
B, P, GEN, DRAFT_K, ADC = 2, 8, 10, 4, 5   # lock-step and speculative
SLOTS, CAP, SCHED_K = 2, 6, 3              # the scheduler
LAYOUT, CHUNK = (4, 6, 24), 4              # block size, table width, blocks


class _RerunGraph(G.StepGraph):
    """No CUDA: the warm-up runs the body, the capture runs nothing, and
    a replay runs the body again (tests/test_torch_graphs.py)."""

    def _warm(self):
        return self.body()

    def _record(self):
        def replay():
            self.outputs = self.body()
        return types.SimpleNamespace(replay=replay), None


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tcfg, "cpu")
    return jp, jcfg, tp, tcfg


@pytest.fixture
def rerun_graphs(monkeypatch):
    """The drivers replay ``_RerunGraph``s on the CPU."""
    for mod in (TSV, TS):
        monkeypatch.setattr(mod, "StepGraph", _RerunGraph)
        monkeypatch.setattr(mod, "use_graphs", lambda graphs, dev: True)


def _requests(paged: bool):
    if paged:
        return TS.shared_prefix_requests(4, 4, 3, P, 512,
                                         stop_lengths=(2, CAP, 3), seed=2)
    return TS.mixed_length_requests(4, P, 512, stop_lengths=(2, CAP, 3),
                                    seed=1)


def _sched_kw(case: str, layout, draft):
    kw = dict(slots=SLOTS, prompt_len=P, max_new_cap=CAP, temperature=T)
    if case == "sched_paged":
        kw.update(paged=layout(*LAYOUT), prefill_chunk=CHUNK)
    if case == "sched_spec":
        kw.update(draft_k=SCHED_K, draft_plan=draft)
    return kw


CASES = ("serve_t0.7", "serve_t8", "spec", "sched_contiguous",
         "sched_paged", "sched_spec")


@pytest.fixture(scope="module", params=CASES)
def reference(request, models):
    """(case, the reference's tokens and counts)."""
    jp, jcfg, _, _ = models
    case = request.param
    if case.startswith("serve"):
        temp = 8.0 if case == "serve_t8" else T
        return case, np.asarray(jserve("minicpm-2b", smoke=True, batch=B,
                                       prompt_len=P, gen=GEN, cim=True,
                                       temperature=temp))
    if case == "spec":
        toks, st = jspec("minicpm-2b", smoke=True, batch=B, prompt_len=P,
                         gen=GEN, draft_k=DRAFT_K, draft_adc_bits=ADC,
                         temperature=T, return_stats=True,
                         compare_baseline=False)
        return case, (np.asarray(toks), st)
    reqs = [JS.Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens)
            for r in _requests(case == "sched_paged")]
    rep = JS.ContinuousBatchingScheduler(
        jlm.pack_cim_params(jp, jcfg), jcfg,
        **_sched_kw(case, JLayout, jdraft(jcfg, ADC))).run(reqs)
    return case, (rep.tokens_by_rid(), rep.n_drafted, rep.n_accepted)


def _port(case, tp, tcfg):
    if case.startswith("serve"):
        temp = 8.0 if case == "serve_t8" else T
        return TSV.serve("minicpm-2b", smoke=True, batch=B, prompt_len=P,
                         gen=GEN, cim=True, temperature=temp, device="cpu",
                         params=tp, return_stats=True)
    if case == "spec":
        return TSV.serve_speculative(
            "minicpm-2b", smoke=True, batch=B, prompt_len=P, gen=GEN,
            draft_k=DRAFT_K, draft_adc_bits=ADC, temperature=T,
            device="cpu", params=tp, return_stats=True,
            compare_baseline=False)
    sched = TS.ContinuousBatchingScheduler(
        tlm.pack_cim_params(tp, tcfg, "cpu"), tcfg,
        **_sched_kw(case, TLayout, tdraft(tcfg, ADC)))
    rep = sched.run(_requests(case == "sched_paged"))
    return rep.tokens_by_rid(), rep


@pytest.mark.parametrize("replay", ["eager", "rerun_graph"])
def test_sampled_tokens_equal_reference(request, models, reference, replay):
    _, _, tp, tcfg = models
    case, want = reference
    if replay == "rerun_graph":
        request.getfixturevalue("rerun_graphs")
    got, info = _port(case, tp, tcfg)
    if case.startswith("serve"):
        np.testing.assert_array_equal(got, want, err_msg=case)
        assert info["graphs"] is (replay == "rerun_graph")
    elif case == "spec":
        want, wstats = want
        np.testing.assert_array_equal(got, want, err_msg=case)
        for key in ("n_rounds", "n_drafted", "n_accepted"):
            assert info[key] == wstats[key], key
        # a clipping draft: some drafts are rejected and resampled
        assert 0 < info["n_accepted"] < info["n_drafted"]
    else:
        want, n_drafted, n_accepted = want
        assert sorted(got) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                          err_msg=f"{case} request {rid}")
        assert (info.n_drafted, info.n_accepted) == (n_drafted, n_accepted)


def test_sampling_key_and_first_token(models):
    """The sampling stream is the reference's, distinct from the init
    stream; the first token is sampled (at T 8 it differs from the greedy
    one) and a seed's sampled run repeats."""
    _, _, tp, _ = models
    for seed in (0, 3, 2 ** 32 - 1):
        assert np.array_equal(np.asarray(JS.sampling_key(seed)).astype(
            np.int64), TS.sampling_key(seed).numpy())
    kw = dict(smoke=True, batch=4, prompt_len=P, gen=2, cim=True,
              device="cpu", params=tp)
    greedy = TSV.serve("minicpm-2b", **kw)
    hot = TSV.serve("minicpm-2b", temperature=8.0, **kw)
    assert (greedy[:, 0] != hot[:, 0]).any()
    np.testing.assert_array_equal(
        hot, TSV.serve("minicpm-2b", temperature=8.0, **kw))


@pytest.mark.parametrize("case", ["sched_contiguous", "sched_spec"])
def test_temperature_pool_matches_solo(models, case):
    """Per-request streams (fold_in by rid): a pooled request samples the
    tokens it samples alone, speculative rounds at a fixed draft_k
    included."""
    _, _, tp, tcfg = models
    sched = TS.ContinuousBatchingScheduler(
        tlm.pack_cim_params(tp, tcfg, "cpu"), tcfg,
        **_sched_kw(case, TLayout, tdraft(tcfg, ADC)))
    reqs = _requests(False)
    pool = sched.run(reqs).tokens_by_rid()
    for r in reqs:
        np.testing.assert_array_equal(
            pool[r.rid], sched.run([r]).tokens_by_rid()[r.rid],
            err_msg=f"{case} request {r.rid}")


def test_serve_continuous_at_temperature(models):
    """The driver: a sampled pool equals the sampled lock-step waves
    (asserted inside), and a sampled speculative pool is compared with
    nothing, as in the reference."""
    _, _, tp, _ = models
    kw = dict(smoke=True, slots=SLOTS, prompt_len=P, n_requests=4,
              stop_lengths=(2, CAP, 3), cim=True, temperature=T,
              device="cpu", params=tp)
    _, stats = TSV.serve_continuous("minicpm-2b", **kw)
    assert stats["tokens_match_lockstep"] and stats["temperature"] == T
    _, stats = TSV.serve_continuous("minicpm-2b", draft_k=2, **kw)
    assert "lockstep" not in stats and stats["draft_k"] == 2
