"""Port parity: the vlm (paligemma-3b) and audio (musicgen-medium)
families' serving paths at smoke size against the reference's, with
weights bridged from the reference ``lm.init`` through numpy.

- ``serve``: greedy tokens ``==`` ``repro.launch.serve.serve`` in float,
  packed CIM, unpacked CIM, sampled (T 0.7) and noisy CIM mode for both
  archs; paligemma's run prefills the data pipeline's 8 frontend
  embeddings ahead of every prompt under the prefix-LM mask, and its
  ``prefill_tok_s`` counts them.
- ``serve_speculative`` (text-only, as the reference's): tokens and round
  counters ``==`` the reference's for both archs; musicgen's equal its
  own ``serve``'s (paligemma's ``serve`` has the frontend prefix, the
  speculative driver does not, in both packages).
- musicgen through the continuous-batching scheduler: contiguous (pool
  == lock-step waves), paged with chunked prefill and a shared prefix
  (pool == solo), and speculative rounds under a 5-bit analog draft:
  tokens and counters ``==`` the reference scheduler's.
- The scheduler refuses the vlm family with the reference's message.

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
from repro.launch.serve import serve as jserve
from repro.launch.serve import serve_speculative as jspec
from repro.models import lm as jlm
from repro.plan import draft_plan_for_model as jdraft
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.launch import scheduler as TS
from repro_torch.launch.paging import PagedLayout as TLayout
from repro_torch.launch.serve import serve as tserve
from repro_torch.launch.serve import serve_speculative as tspec
from repro_torch.models import lm as tlm
from repro_torch.plan import draft_plan_for_model as tdraft

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

ARCHS = ("paligemma-3b", "musicgen-medium")
P, CAP, SLOTS, K, ADC = 16, 6, 2, 3, 5
LAYOUT, CHUNK = (4, 7, 30), 8           # block size, table width, blocks
SERVE_MODES = {"fp": dict(cim=False), "packed": dict(cim=True),
               "unpacked": dict(cim=True, pack=False),
               "sampled": dict(cim=True, temperature=0.7),
               "noisy": dict(cim=True, noise_seed=0)}
SERVE_KW = dict(smoke=True, batch=2, prompt_len=16, gen=8, seed=0)


def _float_params(arch):
    jp, _ = jlm.init(jax.random.PRNGKey(0), jget(arch, smoke=True))
    return jp, params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tget(arch, smoke=True), "cpu")


@pytest.mark.parametrize("mode", list(SERVE_MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_reference(arch, mode):
    kw = dict(SERVE_KW, **SERVE_MODES[mode])
    want = jserve(arch, **kw)
    got = tserve(arch, device="cpu", params=_float_params(arch)[1], **kw)
    np.testing.assert_array_equal(got, want)


def test_vlm_prefill_tok_s_counts_frontend_tokens():
    """``prefill_tok_s`` counts the frontend tokens paligemma prepends,
    not just the text prompt (the reference's own check)."""
    cfg = tget("paligemma-3b", smoke=True)
    batch, prompt_len = 2, 8
    _, stats = tserve("paligemma-3b", batch=batch, prompt_len=prompt_len,
                      gen=2, return_stats=True, device="cpu")
    implied_len = stats["prefill_tok_s"] * stats["prefill_s"] / batch
    true_len = prompt_len + cfg.n_frontend_tokens
    assert abs(implied_len - true_len) / true_len < 0.05, stats
    assert stats["n_frontend"] == cfg.n_frontend_tokens == 8
    _, stats = tserve("musicgen-medium", batch=batch, prompt_len=prompt_len,
                      gen=2, return_stats=True, device="cpu")
    assert stats["n_frontend"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_lockstep_equals_reference(arch):
    kw = dict(smoke=True, batch=2, prompt_len=16, gen=12, draft_k=4,
              draft_adc_bits=ADC, return_stats=True)
    want, wstats = jspec(arch, compare_baseline=False, **kw)
    vlm = arch == "paligemma-3b"
    got, gstats = tspec(arch, device="cpu", params=_float_params(arch)[1],
                        compare_baseline=not vlm, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    for key in ("n_rounds", "n_drafted", "n_accepted"):
        assert gstats[key] == wstats[key], key
    assert gstats.get("tokens_match_baseline", vlm)


# ---------------------------------------------------------------------------
# the scheduler: musicgen on every path, paligemma refused
# ---------------------------------------------------------------------------


def _jreqs(reqs):
    return [JS.Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens,
                       stop_token=r.stop_token) for r in reqs]


def _mixed():
    return TS.mixed_length_requests(6, P, 512, stop_lengths=(2, CAP, 3, 5),
                                    seed=1)


def _shared():
    """Half the requests share an 8-token prefix (two whole blocks)."""
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
    arch = "musicgen-medium"
    jcfg = dataclasses.replace(jget(arch, smoke=True), cim_mode=True)
    tcfg = dataclasses.replace(tget(arch, smoke=True), cim_mode=True)
    jp, tp = _float_params(arch)
    jpk, tpk = jlm.pack_cim_params(jp, jcfg), tlm.pack_cim_params(tp, tcfg,
                                                                   "cpu")
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
                paged=paged, got_c=cont.run(_mixed()),
                got_p=paged.run(_shared()), got_s=spec.run(_mixed()))


def test_contiguous_pool_equals_reference_and_lockstep(runs):
    got, want = runs["got_c"], runs["want_c"]
    _assert_tokens_equal(got, want)
    assert (got.n_steps, got.n_admits) == (int(want.n_steps),
                                           int(want.n_admits))
    _assert_tokens_equal(runs["cont"].run_lockstep(_mixed()), got)


def test_paged_pool_equals_reference_and_solo(runs):
    got, want = runs["got_p"], runs["want_p"]
    _assert_tokens_equal(got, want)
    assert got.peak_blocks == want.peak_blocks > 0
    assert got.n_pf == want.n_pf > len(got.finished)    # chunked prefill
    assert runs["paged"].last_prefix_plan.stats()["shared_blocks"] > 0
    _drained(got)
    r = _shared()[0]
    solo = runs["paged"].run([r])
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


def test_vlm_scheduler_refused_as_the_reference():
    msg = "scheduler is text-only for now (no per-request frontends)"
    jcfg = jget("paligemma-3b", smoke=True)
    with pytest.raises(NotImplementedError, match=msg.replace("(", r"\(")
                       .replace(")", r"\)")):
        JS.ContinuousBatchingScheduler(None, jcfg, slots=2, prompt_len=8,
                                       max_new_cap=4)
    with pytest.raises(NotImplementedError) as err:
        TS.ContinuousBatchingScheduler({}, tget("paligemma-3b", smoke=True),
                                       slots=2, prompt_len=8, max_new_cap=4)
    assert str(err.value) == msg
