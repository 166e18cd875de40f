"""Port parity: the deployment planner (``plan/profiler.py``,
``plan/search.py``) and the ``launch/plan_pareto.py`` twin, on the
minicpm-2b smoke model with weights from the reference ``lm.init``.

The reference's profile and searches run once per module.  Everything
that is plain Python on both sides is compared with ``==``: site lists
and shapes, MAC counts, modeled costs (the same float64 arithmetic over
the same assignment), assignments, the sequence of moves (site and
label) and the revert count.  The profiler's forwards are the same
macro arithmetic as the reference's (``tests/test_torch_unpacked.py``
holds ``lm.forward``), and the calibration logits are compared with
``==`` (``LOGIT_RESIDUE``: 0 on an AVX512-BF16 host, where the port's
lm_head sums in XLA-CPU's order; elsewhere one, rtol 2^-7).
The RMS values (the table, move scores, measured RMS) are held to rtol
1e-4: the port sums the squares of the logits in float64, where the
reference sums float32 squares in XLA-CPU's order for its eager
``jnp.linalg.norm``.  That order was measured and not reduced to a rule
(``tools/rms_order_probe.py``: a one-axis sum is XLA's 32-wide windowed
order on every trial, but the (1, 8, 512) logits' three-axis sum
matches none of the windowed, sequential or per-axis rules on more than
2 of 10 trials), so the float64 sum stays (the two differ by about 5e-7
relative), and a logit one bf16 step apart in either forward moves a
site's RMS by up to ~2e-5 relative at this size.
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
from repro.models import lm as jlm
from repro_torch import plan as TP
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax, plan_from_jax
from repro_torch.core.ccim import DEFAULT_CONFIG
from repro_torch.launch import plan_pareto
from repro_torch.models import layers as tL

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

SITES = ["mlp/w2", "mlp/w3", "attn/wv"]
RTOL = 1e-4            # the RMS values' bound (module docstring)
# calibration logits apart (module docstring)
LOGIT_RESIDUE = 0 if tL.bf16_dot_host() else 1


def _jcands():
    return [JP.digital_candidate(), JP.prototype_candidate(),
            JP.make_candidate("hybrid3/adc8/L32", dataclasses.replace(
                J_DEFAULT, acc_len=32, adc_bits=8))]


def _tcands():
    return [TP.digital_candidate(), TP.prototype_candidate(),
            TP.make_candidate("hybrid3/adc8/L32", dataclasses.replace(
                DEFAULT_CONFIG, acc_len=32, adc_bits=8))]


@pytest.fixture(scope="module")
def ref():
    """The reference model, its profile over SITES (noisy, the profiler's
    default seed), its searches at budget scales 1.0 and 0.3, and its
    evaluation of the tight plan."""
    cfg = jget("minicpm-2b", smoke=True)
    params, _ = jlm.init(jax.random.PRNGKey(0), cfg)
    toks = JP.calibration_batch(cfg, batch=1, seq_len=8)
    logits = JP.reference_logits(params, cfg, toks)
    prof = JP.profile_sensitivities(params, cfg, toks, _jcands(),
                                    sites=SITES, ref=logits)
    res = JP.pareto_search(params, cfg, toks, candidates=_jcands(),
                           profile=prof, ref=logits)
    tight = JP.pareto_search(params, cfg, toks, candidates=_jcands(),
                             profile=prof, ref=logits, budget_scale=0.3)
    ev = JP.evaluate_plan(params, cfg, toks, tight.plan, prof, ref=logits)
    return dict(cfg=cfg, params=params, toks=toks, logits=np.asarray(logits),
                prof=prof, res=res, tight=tight, ev=ev)


@pytest.fixture(scope="module")
def port(ref):
    cfg = tget("minicpm-2b", smoke=True)
    params = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)),
                     ref["params"]), cfg, "cpu")
    toks = TP.calibration_batch(cfg, batch=1, seq_len=8)
    logits = TP.reference_logits(params, cfg, toks)
    prof = TP.profile_sensitivities(params, cfg, toks, _tcands(),
                                    sites=SITES, ref=logits)
    return dict(cfg=cfg, params=params, toks=toks, logits=logits, prof=prof)


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= RTOL * abs(b)


def test_calibration_and_logits_equal_reference(ref, port):
    np.testing.assert_array_equal(port["toks"], ref["toks"])
    got = port["logits"].numpy()
    assert int((got != ref["logits"]).sum()) <= LOGIT_RESIDUE
    np.testing.assert_allclose(got, ref["logits"], rtol=2 ** -7, atol=0)
    plan = JP.DeploymentPlan.from_dict({"mlp/w2": JP.prototype_candidate()
                                        .entry}, default=JP.FLOAT_ENTRY)
    want = np.asarray(JP.planned_logits(ref["params"], ref["cfg"],
                                        ref["toks"], plan))
    got = TP.planned_logits(port["params"], port["cfg"], port["toks"],
                            plan_from_jax(plan)).numpy()
    assert int((got != want).sum()) <= LOGIT_RESIDUE
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


def test_profile_equals_reference(ref, port):
    jp, tp = ref["prof"], port["prof"]
    assert tp.sites == jp.sites and tp.labels == jp.labels
    assert tp.site_shapes == jp.site_shapes
    assert {s: tp.macs_per_token(s) for s in tp.sites} == {
        s: jp.macs_per_token(s) for s in jp.sites}
    for s in jp.sites:
        for label in jp.labels:
            assert _close(tp.rms[s][label], jp.rms[s][label]), (s, label)
    assert tp.macs_per_token("mlp/w2") == port["cfg"].n_layers * 256 * 128


def _same_result(got, want):
    assert got.assignment == want.assignment
    assert [(s, lab) for s, lab, _ in got.moves] == [
        (s, lab) for s, lab, _ in want.moves]
    for (_, _, a), (_, _, b) in zip(got.moves, want.moves):
        assert _close(a, b)
    assert got.n_reverts == want.n_reverts
    assert got.cost == want.cost
    assert got.cost_digital == want.cost_digital
    assert got.cost_budget_plan == want.cost_budget_plan
    for f in ("predicted_rms", "measured_rms", "budget_predicted",
              "budget_measured"):
        assert _close(getattr(got, f), getattr(want, f)), f
    assert got.plan == plan_from_jax(want.plan)


@pytest.mark.parametrize("scale", [1.0, 0.3])
def test_pareto_search_equals_reference(ref, port, scale):
    want = ref["res"] if scale == 1.0 else ref["tight"]
    got = TP.pareto_search(port["params"], port["cfg"], port["toks"],
                           candidates=_tcands(), profile=port["prof"],
                           ref=port["logits"], budget_scale=scale)
    _same_result(got, want)
    assert got.measured_rms <= got.budget_measured * 1.02 + 1e-9
    assert got.cost["combined"] <= got.cost_digital["combined"] + 1e-9
    assert set(got.summary()) == set(want.summary())


def test_evaluate_plan_equals_reference(ref, port):
    want = ref["ev"]
    got = TP.evaluate_plan(port["params"], port["cfg"], port["toks"],
                           plan_from_jax(ref["tight"].plan), port["prof"],
                           ref=port["logits"])
    assert set(got) == set(want)
    for k in want:
        if k == "measured_rms":
            assert _close(got[k], want[k])
        else:
            assert got[k] == want[k], k


def _error_cases(P, D, side):
    """(call, message) pairs of one package: ``P`` its plan module, ``D``
    its default macro config, ``side`` its model fixture."""
    p, cfg, toks, prof = side["params"], side["cfg"], side["toks"], \
        side["prof"]
    cands = lambda: [P.digital_candidate(), P.prototype_candidate()]
    proto = P.prototype_candidate()
    impostor = P.make_candidate("digital",
                                dataclasses.replace(D, n_dcim_products=1))
    dup = P.make_candidate(proto.label, dataclasses.replace(D, adc_bits=6))
    budget = P.make_candidate("x", dataclasses.replace(D, adc_bits=9))
    return [
        (lambda: P.pareto_search(p, cfg, toks, candidates=[impostor]),
         "reserved"),
        (lambda: P.pareto_search(p, cfg, toks, candidates=[proto, dup]),
         "duplicate candidate labels"),
        (lambda: P.pareto_search(p, cfg, toks,
                                 candidates=[P.make_candidate("x", D)],
                                 budget_candidate=budget),
         "collides with the budget"),
        (lambda: P.profile_sensitivities(p, cfg, toks, cands(),
                                         sites=["attn/nope"],
                                         ref=side["logits"]),
         "unknown projection site"),
        (lambda: P.pareto_search(p, cfg, toks, candidates=cands(),
                                 profile=prof, sites=["attn/wq"],
                                 ref=side["logits"]),
         "not in the precomputed profile"),
    ]


def test_error_paths_raise_as_reference(ref, port):
    """Label collisions, an unknown site and sites outside a precomputed
    profile raise the reference's ValueError on both sides."""
    for (jcall, jmsg), (tcall, tmsg) in zip(
            _error_cases(JP, J_DEFAULT, ref),
            _error_cases(TP, DEFAULT_CONFIG, port)):
        with pytest.raises(ValueError, match=jmsg) as jerr:
            jcall()
        with pytest.raises(ValueError, match=tmsg) as terr:
            tcall()
        assert str(terr.value) == str(jerr.value)


def test_partial_profile_gets_missing_columns(ref, port):
    """A precomputed profile without the digital and budget columns gets
    them profiled and merged, and a ``sites`` subset restricts the plan."""
    p, cfg, toks = port["params"], port["cfg"], port["toks"]
    proto = TP.prototype_candidate()
    full = port["prof"]
    part = TP.SensitivityProfile(
        sites=list(full.sites), site_shapes=dict(full.site_shapes),
        labels=[proto.label],
        rms={s: {proto.label: full.rms[s][proto.label]} for s in full.sites})
    res = TP.pareto_search(p, cfg, toks, candidates=[proto], profile=part,
                           sites=SITES[:2], ref=port["logits"])
    assert set(res.assignment) == set(SITES[:2])
    assert res.profile.labels == [proto.label, "digital"]
    for s in SITES[:2]:
        assert res.profile.rms[s]["digital"] == full.rms[s]["digital"]


def test_plan_pareto_twin_points(port, capsys):
    """The twin's four points at smoke size on the small grid: each
    point's RMS and cost are the planner's own, the tight plan spends
    more digital, the first three carry decode tok/s from ``serve``, and
    the domination flags follow the points."""
    out = plan_pareto.run_arch(smoke=True, batch=1, prompt_len=8, gen=3,
                               device="cpu", params=port["params"],
                               candidates=_tcands())
    pts = out["points"]
    assert list(pts) == ["global_digital", "global_hybrid", "planned_mixed",
                         "planned_tight"]
    assert "decode_tok_s" not in pts["planned_tight"]
    for name in ("global_digital", "global_hybrid", "planned_mixed"):
        assert pts[name]["decode_tok_s"] > 0
    assert pts["global_digital"]["combined"] == 1.0
    assert pts["planned_tight"]["combined"] >= pts["planned_mixed"][
        "combined"]
    pm, gh = pts["planned_mixed"], pts["global_hybrid"]
    assert out["planned_dominated_by_global_hybrid"] == (
        pm["measured_rms"] > gh["measured_rms"]
        and pm["combined"] > gh["combined"])
    assert not out["planned_dominated_by_global_hybrid"]
    assert list(out["sensitivity"]) == list(out["sites"])
    assert len(out["sites"]) == 7
