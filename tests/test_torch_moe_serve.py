"""Port parity: the moe family's serving paths at smoke size against the
reference's, with packed CIM weights bridged from the reference
``lm.init`` through numpy.

- qwen2-moe-a2.7b through the continuous-batching scheduler: contiguous
  (6 requests over 2 slots), paged with chunked prefill and a shared
  prefix, and speculative rounds (``draft_k``, contiguous and paged)
  under a clipping 5-bit analog draft.  Greedy tokens and the step,
  admit and draft counters ``==`` the reference's; pool == lock-step,
  paged == contiguous, pool == solo, every refcount drained.
- ``serve_speculative`` (lock-step rounds): tokens and round counters
  ``==`` the reference's and the port's ``serve``.
- ``lm.verify_step`` == the decode chain (contiguous and paged caches):
  the routed experts' dispatch does not depend on how many tokens come
  with a row.
- arctic-480b (the dense residual beside the moe) through the contiguous
  scheduler and the ``serve_continuous`` driver.

Each reference scheduler runs once per module (a fixture).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import scheduler as JS
from repro.launch.paging import PagedLayout as JLayout
from repro.launch.serve import serve_speculative as jspec
from repro.models import lm as jlm
from repro.plan import draft_plan_for_model as jdraft
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.launch import scheduler as TS
from repro_torch.launch.paging import PagedLayout as TLayout
from repro_torch.launch.serve import serve as tserve
from repro_torch.launch.serve import serve_continuous
from repro_torch.launch.serve import serve_speculative as tspec
from repro_torch.models import lm as tlm
from repro_torch.plan import draft_plan_for_model as tdraft

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

ARCH = "qwen2-moe-a2.7b"
P, CAP, SLOTS, K, ADC = 16, 6, 2, 3, 5
LAYOUT, CHUNK = (4, 7, 30), 8           # block size, table width, blocks


def _models(arch):
    jcfg = dataclasses.replace(jget(arch, smoke=True), cim_mode=True)
    tcfg = dataclasses.replace(tget(arch, smoke=True), cim_mode=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tcfg, "cpu")
    return (jlm.pack_cim_params(jp, jcfg), jcfg,
            tlm.pack_cim_params(tp, tcfg, "cpu"), tcfg, tp)


def _jreqs(reqs):
    return [JS.Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens,
                       stop_token=r.stop_token) for r in reqs]


def _mixed():
    return TS.mixed_length_requests(6, P, 512, stop_lengths=(2, CAP, 3, 5),
                                    seed=1)


def _shared():
    """Half the requests share an 8-token prefix (two whole blocks);
    prompts of 10-16 tokens."""
    return TS.shared_prefix_requests(6, 8, 10, P, 512,
                                     stop_lengths=(3, CAP, 5), seed=2)


def _assert_tokens_equal(got, want):
    got, want = got.tokens_by_rid(), want.tokens_by_rid()
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))


def _drained(rep):
    np.testing.assert_array_equal(rep.ref_final, [1] + [0] * (LAYOUT[2] - 1))


@pytest.fixture(scope="module")
def runs():
    jpk, jcfg, tpk, tcfg, tp = _models(ARCH)
    kw = dict(slots=SLOTS, prompt_len=P, max_new_cap=CAP)
    pkw = dict(kw, prefill_chunk=CHUNK)
    skw = dict(kw, draft_k=K)
    want_c = JS.ContinuousBatchingScheduler(jpk, jcfg, **kw).run(
        _jreqs(_mixed()))
    want_p = JS.ContinuousBatchingScheduler(
        jpk, jcfg, paged=JLayout(*LAYOUT), **pkw).run(_jreqs(_shared()))
    want_s = JS.ContinuousBatchingScheduler(
        jpk, jcfg, draft_plan=jdraft(jcfg, ADC), **skw).run(
        _jreqs(_mixed()))
    cont = TS.ContinuousBatchingScheduler(tpk, tcfg, **kw)
    paged = TS.ContinuousBatchingScheduler(
        tpk, tcfg, paged=TLayout(*LAYOUT), **pkw)
    spec = TS.ContinuousBatchingScheduler(
        tpk, tcfg, draft_plan=tdraft(tcfg, ADC), **skw)
    return dict(want_c=want_c, want_p=want_p, want_s=want_s, cont=cont,
                paged=paged, spec=spec, got_c=cont.run(_mixed()),
                got_p=paged.run(_shared()), got_s=spec.run(_mixed()),
                tpk=tpk, tcfg=tcfg, tp=tp)


def test_contiguous_pool_equals_reference_and_lockstep(runs):
    got, want = runs["got_c"], runs["want_c"]
    _assert_tokens_equal(got, want)
    assert (got.n_steps, got.n_admits) == (int(want.n_steps),
                                           int(want.n_admits))
    _assert_tokens_equal(runs["cont"].run_lockstep(_mixed()), got)


def test_paged_pool_equals_reference_and_contiguous(runs):
    got, want = runs["got_p"], runs["want_p"]
    _assert_tokens_equal(got, want)
    assert got.peak_blocks == want.peak_blocks > 0
    assert got.n_pf == want.n_pf > len(got.finished)    # chunked prefill
    assert runs["paged"].last_prefix_plan.stats()["shared_blocks"] > 0
    _drained(got)
    # the contiguous pool's workload through the paged pool
    _assert_tokens_equal(runs["paged"].run(_mixed()), runs["got_c"])


def test_paged_pool_equals_solo(runs):
    sched, got = runs["paged"], runs["got_p"]
    for r in _shared()[:2]:
        solo = sched.run([r])
        np.testing.assert_array_equal(solo.tokens_by_rid()[r.rid],
                                      got.tokens_by_rid()[r.rid])
        _drained(solo)


def test_spec_pool_equals_reference_and_nonspec(runs):
    got, want = runs["got_s"], runs["want_s"]
    _assert_tokens_equal(got, want)
    _assert_tokens_equal(got, runs["got_c"])
    assert (got.n_drafted, got.n_accepted, got.n_steps) == (
        int(want.n_drafted), int(want.n_accepted), int(want.n_steps))
    assert 0 < got.n_accepted < got.n_drafted       # rejections happened


def test_paged_spec_pool_equals_nonspec(runs):
    sched = TS.ContinuousBatchingScheduler(
        runs["tpk"], runs["tcfg"], slots=SLOTS, prompt_len=P,
        max_new_cap=CAP, draft_k=K, draft_plan=tdraft(runs["tcfg"], ADC),
        paged=TLayout(*LAYOUT), prefill_chunk=CHUNK)
    got = sched.run(_mixed())
    _assert_tokens_equal(got, runs["got_c"])
    _drained(got)


def _verify_vs_chain(params, cfg, cache, B=2, Pn=8, S=4):
    rng = np.random.default_rng(7)
    prompt = torch.tensor(rng.integers(0, 512, (B, Pn))).long()
    toks = torch.tensor(rng.integers(0, 512, (B, S))).long()
    with torch.inference_mode():
        _, cache = tlm.prefill(params, cfg, prompt, cache)
        clone = lambda c: {k: v.clone() for k, v in c.items()}
        c, chain = clone(cache), []
        for i in range(S):
            lg, c = tlm.decode_step(params, cfg, toks[:, i:i + 1], c)
            chain.append(lg[:, -1])
        vlg, vc = tlm.verify_step(params, cfg, toks, clone(cache))
    assert torch.equal(vlg, torch.stack(chain, dim=1))
    for key in ("k", "v"):
        assert torch.equal(vc[key], c[key])


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_verify_step_equals_decode_chain(runs, paged):
    tpk, tcfg = runs["tpk"], runs["tcfg"]
    if paged:
        cache = tlm.init_paged_cache(tcfg, 2, 12, 4, 4, device="cpu")
        cache["table"].copy_(torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]]))
    else:
        cache = tlm.init_cache(tcfg, 2, 13, device="cpu")
    _verify_vs_chain(tpk, tcfg, cache)


def test_speculative_lockstep_equals_reference_and_serve(runs):
    kw = dict(smoke=True, batch=2, prompt_len=16, gen=12, draft_k=4,
              draft_adc_bits=ADC, return_stats=True)
    want, wstats = jspec(ARCH, compare_baseline=False, **kw)
    got, gstats = tspec(ARCH, device="cpu", params=runs["tp"], **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert gstats["tokens_match_baseline"]
    for key in ("n_rounds", "n_drafted", "n_accepted"):
        assert gstats[key] == wstats[key], key
    base = tserve(ARCH, smoke=True, batch=2, prompt_len=16, gen=12, cim=True,
                  device="cpu", params=runs["tp"])
    np.testing.assert_array_equal(got, base)


def test_arctic_contiguous_pool_equals_reference():
    jpk, jcfg, tpk, tcfg, _ = _models("arctic-480b")
    kw = dict(slots=SLOTS, prompt_len=P, max_new_cap=CAP)
    want = JS.ContinuousBatchingScheduler(jpk, jcfg, **kw).run(
        _jreqs(_mixed()))
    got = TS.ContinuousBatchingScheduler(tpk, tcfg, **kw).run(_mixed())
    _assert_tokens_equal(got, want)


def test_serve_continuous_driver_checks_pass():
    """The CLI's driver: pool == lock-step waves; paged == contiguous."""
    kw = dict(smoke=True, slots=SLOTS, prompt_len=8, n_requests=4, cim=True,
              stop_lengths=(2, 5), device="cpu")
    _, stats = serve_continuous(ARCH, **kw)
    assert stats["tokens_match_lockstep"]
    _, stats = serve_continuous(ARCH, paged=TLayout(4, 4, 16),
                                prefill_chunk=4, **kw)
    assert stats["tokens_match_contiguous"]
    assert stats["paged"]["refcounts_drained"]
