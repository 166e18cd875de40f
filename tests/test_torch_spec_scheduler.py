"""Port parity: the continuous-batching scheduler's speculative mode
(``draft_k``, ``adaptive_draft_k``) against the reference's, on the
minicpm-2b smoke model with packed CIM weights taken from the reference
``lm.init`` through numpy.

The workload covers the edges of a variable-length round: a stop token
inside an accepted block, budgets that end mid-block, and slots refilled
while their neighbours are mid-draft (6 requests over 2 slots).  Greedy
pool tokens must equal the reference's speculative scheduler and the
port's non-speculative pool, in contiguous and in paged mode; the draft
counters must equal the reference's.  The draft plan is the all-analog
shadow at a clipping 5-bit ADC, so rounds reject and the adaptive rung
moves.  Each reference scheduler runs once per module (a fixture).
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
from repro.models import lm as jlm
from repro.plan import draft_plan_for_model as jdraft
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.launch import scheduler as TS
from repro_torch.launch.paging import PagedLayout as TLayout
from repro_torch.launch.serve import serve_continuous
from repro_torch.models import lm as tlm
from repro_torch.plan import draft_plan_for_model as tdraft

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

P, CAP, SLOTS, K, ADC = 8, 6, 2, 4, 5
LAYOUT = (4, 6, 24)                     # block size, table width, blocks
CHUNK = 4


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tcfg, "cpu")
    return (jlm.pack_cim_params(jp, jcfg), jcfg,
            tlm.pack_cim_params(tp, tcfg, "cpu"), tcfg)


def _jreqs(reqs):
    return [JS.Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens,
                       stop_token=r.stop_token) for r in reqs]


def _tsched(models, **kw):
    _, _, tp, tcfg = models
    if kw.get("draft_k"):
        kw.setdefault("draft_plan", tdraft(tcfg, ADC))
    if kw.pop("paged", False):
        kw.update(paged=TLayout(*LAYOUT), prefill_chunk=CHUNK)
    return TS.ContinuousBatchingScheduler(tp, tcfg, slots=SLOTS, prompt_len=P,
                                          max_new_cap=CAP, **kw)


@pytest.fixture(scope="module")
def workload(models):
    """Six requests over two slots with budgets 2, 6, 3, 5 (not multiples
    of K); requests 1 and 3 stop on a token their non-speculative run
    emits mid-block (positions 3 and 2), request 5 runs to its budget."""
    reqs = TS.mixed_length_requests(6, P, 512, stop_lengths=(2, CAP, 3, 5),
                                    seed=1)
    free = _tsched(models).run(reqs).tokens_by_rid()
    stops = {1: int(free[1][3]), 3: int(free[3][2])}
    reqs = [dataclasses.replace(r, stop_token=stops.get(r.rid, -1))
            for r in reqs]
    base = _tsched(models).run(reqs)
    for rid, stop in stops.items():
        toks = base.tokens_by_rid()[rid]
        assert toks[-1] == stop and len(toks) < reqs[rid].max_new_tokens
    return reqs, base


@pytest.fixture(scope="module", params=["contiguous", "paged"])
def reference(request, models, workload):
    """The reference's adaptive speculative scheduler on the workload."""
    jpk, jcfg, _, _ = models
    reqs, _ = workload
    kw = dict(slots=SLOTS, prompt_len=P, max_new_cap=CAP, draft_k=K,
              draft_plan=jdraft(jcfg, ADC), adaptive_draft_k=True)
    if request.param == "paged":
        kw.update(paged=JLayout(*LAYOUT), prefill_chunk=CHUNK)
    rep = JS.ContinuousBatchingScheduler(jpk, jcfg, **kw).run(_jreqs(reqs))
    return request.param, rep


def _assert_tokens_equal(got, want):
    got, want = got.tokens_by_rid(), want.tokens_by_rid()
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))


def test_adaptive_spec_pool_equals_reference(models, workload, reference):
    mode, want = reference
    reqs, base = workload
    sched = _tsched(models, draft_k=K, adaptive_draft_k=True,
                    paged=mode == "paged")
    got = sched.run(reqs)
    _assert_tokens_equal(got, want)
    _assert_tokens_equal(got, base)
    assert (got.n_drafted, got.n_accepted) == (int(want.n_drafted),
                                               int(want.n_accepted))
    assert got.n_steps == int(want.n_steps)
    assert 0 < got.n_accepted < got.n_drafted       # rejections happened
    assert got.n_admits == len(reqs)
    assert got.host_syncs == got.n_iter + 1         # one read an iteration
    assert got.summary()["n_drafted"] == got.n_drafted
    if mode == "paged":
        np.testing.assert_array_equal(got.ref_final,
                                      [1] + [0] * (LAYOUT[2] - 1))


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
@pytest.mark.parametrize("draft", ["analog5", "self"])
def test_fixed_k_spec_pool_equals_nonspec(models, workload, mode, draft):
    """Fixed-depth rounds, drafting under the clipping analog shadow or
    under the deployed config itself (every draft accepted): the pool's
    tokens equal the non-speculative pool's, request for request."""
    reqs, base = workload
    kw = dict(draft_k=K, paged=mode == "paged")
    if draft == "self":
        kw["draft_plan"] = None
    got = _tsched(models, **kw).run(reqs)
    _assert_tokens_equal(got, base)
    assert got.draft_steps == K * got.n_steps
    if draft == "self":
        assert got.n_accepted == got.n_drafted > 0
    # a round takes fewer pooled steps than one token each
    assert got.n_steps < base.n_steps


def test_spec_pool_equals_solo_runs(models, workload):
    """Rounds are atomic per slot: a request's tokens do not depend on its
    poolmates or on when it was admitted."""
    reqs, base = workload
    sched = _tsched(models, draft_k=K)
    for r in reqs[:3]:
        solo = sched.run([r]).tokens_by_rid()[r.rid]
        np.testing.assert_array_equal(solo, base.tokens_by_rid()[r.rid])


def test_serve_continuous_speculative_equals_lockstep(models):
    """The driver asserts pool tokens == the non-speculative lock-step
    waves; paged, == the contiguous speculative scheduler."""
    _, _, _, tcfg = models
    kw = dict(smoke=True, slots=SLOTS, prompt_len=P, n_requests=5,
              stop_lengths=(2, 6, 4, 5), cim=True, device="cpu", draft_k=3,
              draft_adc_bits=ADC)
    _, stats = serve_continuous("minicpm-2b", adaptive_draft_k=True, **kw)
    assert stats["tokens_match_lockstep"] and stats["draft_k"] == 3
    assert stats["draft_plan"] == f"draft-analog0/adc{ADC}/L16"
    assert stats["continuous"]["n_drafted"] > 0
    _, stats = serve_continuous("minicpm-2b", paged=TLayout(4, 5, 20),
                                prefill_chunk=4, **kw)
    assert stats["tokens_match_contiguous"]
    assert stats["paged"]["refcounts_drained"]


def test_paged_spec_needs_draft_headroom(models):
    """Four 4-token blocks hold the prompt and budget (8 + 6 - 1) but not
    the K rows a round writes past them."""
    _, _, tp, tcfg = models
    with pytest.raises(ValueError, match="draft headroom"):
        TS.ContinuousBatchingScheduler(
            tp, tcfg, slots=SLOTS, prompt_len=P, max_new_cap=CAP, draft_k=K,
            paged=TLayout(4, 4, 24), prefill_chunk=CHUNK)
