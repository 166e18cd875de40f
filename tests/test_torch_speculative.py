"""Port parity: the speculative-verify forward (``lm.verify_step``) and the
plan-cascade speculative lock-step driver (``serve_speculative``) against
the reference package, on the minicpm-2b smoke model with weights taken
from the reference ``lm.init`` through numpy.

``verify_step``'s logits must equal the port's own chain of decode steps
with ``==`` (the greedy-identity contract: each position is the decode
step's forward row for row), and the reference's ``verify_step`` to one
bf16 rounding step (rtol 2^-7, as in ``tests/test_torch_models.py``).
Speculative greedy tokens must equal the reference's and the port's
non-speculative ones, and the round counts (rounds, drafted and accepted
tokens) the reference's: at draft ADC 8 (no clipping, every draft
accepted) and at 5 (a clipping draft, rejections).  Each reference run
happens once per module (a fixture).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as JP
from repro.configs import get_config as jget
from repro.core.ccim import DEFAULT_CONFIG as J_DEFAULT
from repro.launch.serve import serve_speculative as jspec
from repro.models import lm as jlm
from repro_torch import plan as TP
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax, plan_from_jax
from repro_torch.launch import scheduler as TS
from repro_torch.launch.serve import serve as tserve
from repro_torch.launch.serve import serve_continuous
from repro_torch.launch.serve import serve_speculative as tspec
from repro_torch.models import lm as tlm

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

B, P, S = 2, 8, 4
GEN, K = 24, 8            # serve_speculative: batch 2, prompt 16


def _bridge(jparams, cfg):
    return params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jparams),
        cfg, "cpu")


def _mixed_plan():
    hybrid5 = JP.PlanEntry(cfg=dataclasses.replace(
        J_DEFAULT, n_dcim_products=5, adc_bits=8), label="h5")
    return plan_from_jax(JP.DeploymentPlan.from_dict(
        {"mlp/w3": JP.FLOAT_ENTRY, "attn/wo": hybrid5,
         "mlp/w2": JP.DIGITAL_ENTRY}, default=JP.HYBRID_ENTRY))


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = _bridge(jp, tcfg)
    return jp, jcfg, jlm.pack_cim_params(jp, jcfg), tp, tcfg


def _tokens(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, (B, P), dtype=np.int32),
            rng.integers(0, 512, (B, S), dtype=np.int32))


def _port_verify_vs_chain(params, cfg, cache):
    prompt, toks = _tokens()
    prompt, toks = torch.tensor(prompt).long(), torch.tensor(toks).long()
    with torch.inference_mode():
        _, cache = tlm.prefill(params, cfg, prompt, cache)
        clone = lambda c: {k: v.clone() for k, v in c.items()}
        c, chain = clone(cache), []
        for i in range(S):
            lg, c = tlm.decode_step(params, cfg, toks[:, i:i + 1], c)
            chain.append(lg[:, -1])
        vlg, vc = tlm.verify_step(params, cfg, toks, clone(cache))
    assert vlg.shape == (B, S, 512) and vlg.dtype == torch.float32
    assert torch.equal(vlg, torch.stack(chain, dim=1))
    assert torch.equal(vc["pos"], cache["pos"])        # the caller commits
    return vlg, c, vc


@pytest.mark.parametrize("mode", ["fp", "packed", "mixed_plan"])
def test_verify_step_equals_decode_chain(models, mode):
    _, _, _, tp, tcfg = models
    cfg = {"fp": dataclasses.replace(tcfg, cim_mode=False), "packed": tcfg,
           "mixed_plan": dataclasses.replace(tcfg,
                                             cim_plan=_mixed_plan())}[mode]
    params = tp if mode == "fp" else tlm.pack_cim_params(tp, cfg, "cpu")
    _, chained_cache, vcache = _port_verify_vs_chain(
        params, cfg, tlm.init_cache(cfg, B, P + S + 1, device="cpu"))
    # the verify forward wrote the same KV rows the chain did
    for key in ("k", "v"):
        assert torch.equal(vcache[key], chained_cache[key])


def test_verify_step_paged_equals_decode_chain(models):
    """On a paged cache the verify forward gathers and runs the plain
    read, as the CPU's decode step does; a row outside ``live`` writes
    its draft block to the trash block only."""
    _, _, _, tp, tcfg = models
    params = tlm.pack_cim_params(tp, tcfg, "cpu")
    cache = tlm.init_paged_cache(tcfg, B, 12, 4, 4, device="cpu")
    cache["table"].copy_(torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]]))
    _port_verify_vs_chain(params, tcfg, cache)
    prompt, toks = _tokens(4)
    with torch.inference_mode():
        _, cache = tlm.prefill(params, tcfg, torch.tensor(prompt).long(),
                               cache)
        before = {k: v.clone() for k, v in cache.items()}
        live = torch.tensor([True, False])
        _, after = tlm.verify_step(params, tcfg, torch.tensor(toks).long(),
                                   cache, live=live)
    for key in ("k", "v"):
        # row 1's blocks (5-8) untouched, its draft rows in block 0
        assert torch.equal(after[key][:, 5:], before[key][:, 5:])
        assert not torch.equal(after[key][:, 0], before[key][:, 0])
        assert not torch.equal(after[key][:, 3], before[key][:, 3])


def test_verify_step_matches_reference(models):
    jp, jcfg, jpk, tp, tcfg = models
    prompt, toks = _tokens(5)
    jc = jlm.init_cache(jcfg, B, P + S + 1)
    _, jc = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))(
        jpk, jnp.asarray(prompt), jc)
    jl, _ = jax.jit(lambda p, t, c: jlm.verify_step(p, jcfg, t, c))(
        jpk, jnp.asarray(toks), jc)
    params = tlm.pack_cim_params(tp, tcfg, "cpu")
    with torch.inference_mode():
        _, tc = tlm.prefill(params, tcfg, torch.tensor(prompt).long(),
                            tlm.init_cache(tcfg, B, P + S + 1, device="cpu"))
        tl, _ = tlm.verify_step(params, tcfg, torch.tensor(toks).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2 ** -7,
                               atol=0)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()


# ---------------------------------------------------------------------------
# serve_speculative
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[8, 5], ids=["adc8", "adc5"])
def spec_runs(request, models):
    """The reference's and the port's speculative serve at one draft ADC
    width; the port's also runs its non-speculative baseline and asserts
    equal tokens (compare_baseline)."""
    adc = request.param
    _, _, _, tp, _ = models
    kw = dict(smoke=True, batch=B, prompt_len=16, gen=GEN, draft_k=K,
              draft_adc_bits=adc, return_stats=True)
    want, wstats = jspec("minicpm-2b", compare_baseline=False, **kw)
    got, gstats = tspec("minicpm-2b", device="cpu", params=tp, **kw)
    return adc, want, wstats, got, gstats


def test_speculative_tokens_equal_reference_and_baseline(spec_runs, models):
    adc, want, _, got, gstats = spec_runs
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert gstats["tokens_match_baseline"]         # == the port's serve
    base = tserve("minicpm-2b", smoke=True, batch=B, prompt_len=16, gen=GEN,
                  cim=True, device="cpu", params=models[3])
    np.testing.assert_array_equal(got, base)


def test_speculative_counts_equal_reference(spec_runs):
    adc, _, wstats, _, gstats = spec_runs
    for key in ("n_rounds", "n_drafted", "n_accepted"):
        assert gstats[key] == wstats[key], key
    assert gstats["draft_plan"] == wstats["draft_plan"] == \
        f"draft-analog0/adc{adc}/L16"
    assert gstats["acceptance_rate"] == pytest.approx(
        wstats["acceptance_rate"], abs=1e-4)
    if adc == 8:          # the no-clip analog shadow agrees everywhere
        assert gstats["acceptance_rate"] == 1.0
    else:                 # the clipping draft is rejected: corrections
        assert gstats["acceptance_rate"] < 0.5
    assert gstats["tokens_per_round"] == pytest.approx(
        B * (GEN - 1) / gstats["n_rounds"])


def test_speculative_under_a_plan_equals_planned_serve(models):
    _, _, _, tp, _ = models
    plan = _mixed_plan()
    got, stats = tspec("minicpm-2b", smoke=True, batch=B, prompt_len=8,
                       gen=10, draft_k=3, plan=plan, device="cpu", params=tp,
                       return_stats=True)
    assert stats["tokens_match_baseline"]
    assert stats["draft_plan"] == TP.derive_draft_plan(plan).summary()[
        "<default>"]


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft_k", [-1, 32])
def test_draft_k_outside_range_raises(models, draft_k):
    _, _, _, tp, tcfg = models
    with pytest.raises(ValueError, match="draft_k"):
        TS.ContinuousBatchingScheduler(tp, tcfg, slots=2, prompt_len=8,
                                       max_new_cap=4, draft_k=draft_k)


def test_adaptive_draft_k_requires_speculative(models):
    _, _, _, tp, tcfg = models
    with pytest.raises(ValueError, match="adaptive_draft_k"):
        TS.ContinuousBatchingScheduler(tp, tcfg, slots=2, prompt_len=8,
                                       max_new_cap=4, adaptive_draft_k=True)


def test_temperature_and_metrics_still_raise(models):
    """Sampled speculative decoding (tests/test_torch_sampling.py) and
    telemetry (tests/test_torch_obs.py) are both served now: a
    speculative pool with metrics on, greedy or sampled, gives the
    metrics-off tokens and counts every one of them."""
    kw = dict(smoke=True, draft_k=2, n_requests=4, prompt_len=8,
              stop_lengths=(3, 5), cim=True, device="cpu")
    for temperature in (0.0, 0.7):
        off, _ = serve_continuous("minicpm-2b", temperature=temperature,
                                  **kw)
        on, st = serve_continuous("minicpm-2b", temperature=temperature,
                                  metrics=True, **kw)
        for rid in off:
            np.testing.assert_array_equal(on[rid], off[rid])
        assert st["telemetry"]["counters"]["tokens"] == sum(
            len(t) for t in on.values())


def test_rung_ladder(models):
    _, _, _, tp, tcfg = models
    for k, rungs in ((8, [8, 4, 2]), (4, [4, 2, 1]), (2, [2, 1]), (1, [1])):
        sched = TS.ContinuousBatchingScheduler(
            tp, tcfg, slots=2, prompt_len=8, max_new_cap=4, draft_k=k,
            adaptive_draft_k=True)
        assert sched._rungs == rungs
        assert sched.max_seq == 8 + 4 + k
