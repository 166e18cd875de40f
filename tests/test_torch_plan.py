"""Port parity: deployment plans (``repro_torch.plan``) and mixed-plan
serving against the reference package, on the minicpm-2b smoke model with
weights taken from the reference ``lm.init`` through numpy.

Plan semantics are held as ``tests/test_plan.py`` holds the reference's.
Candidate labels, ADC widths and modeled costs are plain Python on both
sides and must be equal (the costs are computed by the same float64
arithmetic, so ``==``).  The ``MIXED`` pack must equal the reference's bit
for bit, leaf for leaf.  Served under ``MIXED``, greedy tokens must be
equal; logits are held to one bf16 rounding step (rtol 2^-7, as in
``tests/test_torch_models.py``): the same roundings happen on both sides,
but a float32 sum in another order could still move a logit across one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as JP
from repro.configs import get_config as jget
from repro.core import engine as J
from repro.core.ccim import DEFAULT_CONFIG as J_DEFAULT
from repro.data import DataConfig as JData
from repro.data import batch_at as jbatch
from repro.launch.serve import serve as jserve
from repro.models import lm as jlm
from repro_torch import plan as TP
from repro_torch.configs import get_config as tget
from repro_torch.convert import packed_from_jax, params_from_jax, plan_from_jax
from repro_torch.core import engine as T
from repro_torch.core.ccim import DEFAULT_CONFIG
from repro_torch.launch.serve import serve as tserve
from repro_torch.launch.serve import serve_continuous
from repro_torch.models import lm as tlm

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)


def _jentry(label="h", **kw):
    fid = kw.pop("fidelity", "fast")
    return JP.PlanEntry(cfg=dataclasses.replace(J_DEFAULT, **kw),
                        fidelity=fid, label=label)


def _tentry(label="h", **kw):
    fid = kw.pop("fidelity", "fast")
    return TP.PlanEntry(cfg=dataclasses.replace(DEFAULT_CONFIG, **kw),
                        fidelity=fid, label=label)


# the reference's mixed plan (tests/test_plan.py): a digital site, an
# analog-subset site, a hybrid5 site, a float site and an L32 default
J_MIXED = JP.DeploymentPlan.from_dict({
    "mlp/w2": JP.DIGITAL_ENTRY,
    "attn/wq": _jentry("analog0/adc8", n_dcim_products=0, adc_bits=8),
    "attn/wo": _jentry("hybrid5/adc8", n_dcim_products=5, adc_bits=8),
    "mlp/w3": JP.FLOAT_ENTRY,
}, default=_jentry("hybrid3/adc8/L32", acc_len=32, adc_bits=8))
T_MIXED = plan_from_jax(J_MIXED)


def _bridge(jparams, cfg):
    return params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jparams),
        cfg, "cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# plan semantics
# ---------------------------------------------------------------------------


def test_plan_resolution_and_fallback():
    plan = TP.DeploymentPlan.from_dict(
        {"attn/wq": TP.DIGITAL_ENTRY, "w2": _tentry("a", n_dcim_products=0,
                                                    adc_bits=8)},
        default=TP.HYBRID_ENTRY)
    assert plan.resolve("attn/wq").fidelity == "exact"       # exact path
    assert plan.resolve("mlp/w2").label == "a"               # basename
    assert plan.resolve("shared/mlp/w2").label == "a"        # basename, deep
    assert plan.resolve("attn/wk") == TP.HYBRID_ENTRY        # default
    assert plan.resolve(None) == TP.HYBRID_ENTRY


def test_plan_hashable_and_order_independent():
    a = TP.DeploymentPlan.from_dict({"x": TP.DIGITAL_ENTRY,
                                     "y": TP.HYBRID_ENTRY})
    b = TP.DeploymentPlan.from_dict({"y": TP.HYBRID_ENTRY,
                                     "x": TP.DIGITAL_ENTRY})
    assert a == b and hash(a) == hash(b)
    # rides inside the frozen ModelConfig
    cfg = dataclasses.replace(tget("minicpm-2b", smoke=True),
                              cim_mode=True, cim_plan=a)
    hash(cfg)
    assert a.replace_entry("x", TP.HYBRID_ENTRY).as_dict() == {
        "x": TP.HYBRID_ENTRY, "y": TP.HYBRID_ENTRY}


def test_plan_rejects_unservable_fidelity():
    with pytest.raises(ValueError, match="fidelity"):
        TP.PlanEntry(fidelity="bit_true")


def test_plan_from_jax_and_summary_match_reference():
    assert T_MIXED.summary() == J_MIXED.summary()
    assert [p for p, _ in T_MIXED.entries] == [p for p, _ in J_MIXED.entries]
    for (_, te), (_, je) in zip(T_MIXED.entries, J_MIXED.entries):
        assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg)
        assert (te.fidelity, te.label) == (je.fidelity, je.label)
    assert T_MIXED == TP.DeploymentPlan.from_dict({
        "mlp/w2": TP.DIGITAL_ENTRY,
        "attn/wq": _tentry("analog0/adc8", n_dcim_products=0, adc_bits=8),
        "attn/wo": _tentry("hybrid5/adc8", n_dcim_products=5, adc_bits=8),
        "mlp/w3": TP.FLOAT_ENTRY,
    }, default=_tentry("hybrid3/adc8/L32", acc_len=32, adc_bits=8))
    sites = ("attn/wq", "mlp/w1")
    assert (plan_from_jax(JP.plan_for_sites(sites, JP.DIGITAL_ENTRY))
            == TP.plan_for_sites(sites, TP.DIGITAL_ENTRY))


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

_J_CANDS = JP.default_candidates()
_T_CANDS = TP.default_candidates()


@pytest.mark.parametrize("i", range(len(_J_CANDS)))
def test_default_candidates_equal_reference(i):
    """Label, config, ADC width and modeled cost of every candidate."""
    jc, tc = _J_CANDS[i], _T_CANDS[i]
    assert len(_J_CANDS) == len(_T_CANDS) == 15
    assert tc.label == jc.label
    assert dataclasses.asdict(tc.entry.cfg) == dataclasses.asdict(jc.entry.cfg)
    assert tc.entry.fidelity == jc.entry.fidelity
    assert TP.min_adc_bits(tc.entry.cfg) == JP.min_adc_bits(jc.entry.cfg)
    assert tc.cost.as_dict() == jc.cost.as_dict()
    assert (TP.combined_cost(tc, TP.digital_candidate())
            == JP.combined_cost(jc, JP.digital_candidate()))


def test_candidate_helpers_equal_reference():
    assert TP.prototype_candidate().label == JP.prototype_candidate().label
    assert TP.prototype_candidate().label == "hybrid3/adc7/L16"
    assert sorted(TP.candidates_by_label(_T_CANDS)) == sorted(
        c.label for c in _J_CANDS)
    assert TP.combined_cost(TP.digital_candidate(),
                            TP.digital_candidate()) == 1.0
    for cand in _T_CANDS:
        if cand.entry.fidelity == "fast":    # inside the kernels' envelope
            assert T._prepacked_kernel_supported(cand.entry.cfg)


# ---------------------------------------------------------------------------
# draft plans
# ---------------------------------------------------------------------------


def _assert_plans_equal(tp, jp):
    assert [p for p, _ in tp.entries] == [p for p, _ in jp.entries]
    for te, je in [(e, f) for (_, e), (_, f) in zip(tp.entries, jp.entries)
                   ] + [(tp.default, jp.default)]:
        assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg)
        assert (te.fidelity, te.label) == (je.fidelity, je.label)


@pytest.mark.parametrize("adc_bits,adc_delta", [(None, 0), (None, -2),
                                                (5, 0), (9, 0)])
def test_derive_draft_plan_equals_reference(adc_bits, adc_delta):
    tp = TP.derive_draft_plan(T_MIXED, adc_bits, adc_delta)
    jp = JP.derive_draft_plan(J_MIXED, adc_bits, adc_delta)
    _assert_plans_equal(tp, jp)
    assert tp.resolve("mlp/w3") == TP.FLOAT_ENTRY        # float stays float
    for _, e in tp.entries + ((None, tp.default),):
        if e.fidelity != "float":
            assert e.cfg.n_dcim_products == 0
    # every analog shadow serves the verify plan's pack
    for path in ("attn/wq", "attn/wk", "attn/wo", "mlp/w1", "mlp/w2"):
        assert T.pack_compatible(T_MIXED.resolve(path).cfg,
                                 tp.resolve(path).cfg)


def test_draft_plan_sweep_and_model_plan_equal_reference():
    for plan_t, plan_j in ((T_MIXED, J_MIXED),
                           (TP.DeploymentPlan.uniform(TP.HYBRID_ENTRY),
                            JP.DeploymentPlan.uniform(JP.HYBRID_ENTRY))):
        pts_t = TP.draft_plan_sweep(plan_t, adc_deltas=(0, -1, -2, -3))
        pts_j = JP.draft_plan_sweep(plan_j, adc_deltas=(0, -1, -2, -3))
        assert [l for l, _ in pts_t] == [l for l, _ in pts_j]
        for (_, a), (_, b) in zip(pts_t, pts_j):
            _assert_plans_equal(a, b)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=True)
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True)
    _assert_plans_equal(TP.draft_plan_for_model(tcfg),
                        JP.draft_plan_for_model(jcfg))
    _assert_plans_equal(TP.draft_plan_for_model(tcfg, adc_bits=5),
                        JP.draft_plan_for_model(jcfg, adc_bits=5))
    assert TP.draft_plan_for_model(tcfg).default.label == \
        "draft-analog0/adc8/L16"


# ---------------------------------------------------------------------------
# the MIXED pack and mixed-plan serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed():
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True,
                               cim_plan=J_MIXED)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=True,
                               cim_plan=T_MIXED)
    jparams, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tparams = _bridge(jparams, tcfg)
    return (jparams, jcfg, jlm.pack_cim_params(jparams, jcfg),
            tparams, tcfg, tlm.pack_cim_params(tparams, tcfg, "cpu"))


def test_mixed_pack_structure(mixed):
    _, _, _, _, tcfg, tpk = mixed
    blk = tpk["layers"]
    assert sorted(blk["attn"]) == ["wk+wv", "wo", "wq"]
    assert sorted(blk["mlp"]) == ["w1", "w2", "w3"]
    # the float site stays a raw bf16 matrix and splits gate/up
    assert isinstance(blk["mlp"]["w3"], torch.Tensor)
    assert blk["mlp"]["w3"].dtype == torch.bfloat16
    assert blk["mlp"]["w2"].cfg == DEFAULT_CONFIG         # digital: default
    assert blk["attn"]["wq"].cfg.n_dcim_products == 0
    assert blk["attn"]["wq"].kernel_planes.shape[1] == 0  # no planes
    assert blk["attn"]["wo"].cfg.n_dcim_products == 5
    kv = blk["attn"]["wk+wv"]
    assert isinstance(kv, T.FusedPackedCimWeights)
    assert kv.packed.cfg.acc_len == 32 and kv.packed.cfg.adc_bits == 8
    assert blk["mlp"]["w1"].cfg.acc_len == 32
    assert blk["attn"]["wq"].kernel_w.shape[0] == tcfg.n_layers


def test_mixed_pack_equals_reference(mixed):
    _, _, jpk, _, _, tpk = mixed
    for block in ("attn", "mlp"):
        jb, tb = jpk["layers"][block], tpk["layers"][block]
        assert sorted(jb) == sorted(tb)
        for key in jb:
            a, b = jb[key], tb[key]
            if not isinstance(a, (J.PackedCimWeights,
                                  J.FusedPackedCimWeights)):
                np.testing.assert_array_equal(
                    np.asarray(a.astype(jnp.float32)), b.float().numpy())
                continue
            if isinstance(a, J.FusedPackedCimWeights):
                assert isinstance(b, T.FusedPackedCimWeights)
                assert (a.seg_names, a.seg_dims) == (b.seg_names, b.seg_dims)
                a, b = a.packed, b.packed
            mapped = packed_from_jax(_np(a), "cpu")
            assert mapped.cfg == b.cfg, key
            for f in ("scale", "kernel_w", "kernel_planes"):
                assert torch.equal(getattr(mapped, f), getattr(b, f)), (key, f)


def test_packed_leaf_on_float_site_raises(mixed):
    _, _, _, tparams, tcfg, tpk = mixed
    bad = dataclasses.replace(
        tcfg, cim_plan=T_MIXED.replace_entry("attn/wo", TP.FLOAT_ENTRY))
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="float"):
        tlm.prefill(tpk, bad, toks, tlm.init_cache(bad, 1, 8, device="cpu"))
    # raw weights on a fast site are served unpacked, equal to the pack
    raw, _ = tlm.prefill(tparams, tcfg, toks,
                         tlm.init_cache(tcfg, 1, 8, device="cpu"))
    packed, _ = tlm.prefill(tpk, tcfg, toks,
                            tlm.init_cache(tcfg, 1, 8, device="cpu"))
    assert torch.equal(raw, packed)


def test_mixed_prefill_logits_match_reference(mixed):
    jparams, jcfg, jpk, _, tcfg, tpk = mixed
    toks = jbatch(JData(vocab_size=512, seq_len=16, global_batch=2, seed=3),
                  0)["tokens"]
    jl, _ = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))(
        jpk, jnp.asarray(toks), jlm.init_cache(jcfg, 2, 24))
    tl, _ = tlm.prefill(tpk, tcfg, torch.tensor(toks).long(),
                        tlm.init_cache(tcfg, 2, 24, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2 ** -7,
                               atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_mixed_serve_tokens_and_logits_equal_reference(seed):
    jparams, _ = jlm.init(jax.random.PRNGKey(seed),
                          jget("minicpm-2b", smoke=True))
    tparams = _bridge(jparams, tget("minicpm-2b", smoke=True))
    want = jserve("minicpm-2b", smoke=True, seed=seed, plan=J_MIXED)
    got, stats = tserve("minicpm-2b", smoke=True, seed=seed, device="cpu",
                        params=tparams, plan=T_MIXED, return_stats=True)
    np.testing.assert_array_equal(want, got)
    assert stats["cim"] and stats["plan"] == J_MIXED.summary()
    # the last decode step's logits: the reference's decode chain fed the
    # same tokens
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True,
                               cim_plan=J_MIXED)
    jpk = jlm.pack_cim_params(jparams, jcfg)
    prompt = jbatch(JData(vocab_size=512, seq_len=32, global_batch=4,
                          seed=seed), 0)["tokens"]
    cache = jlm.init_cache(jcfg, 4, 48)
    _, cache = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))(
        jpk, jnp.asarray(prompt), cache)
    step = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))
    for i in range(want.shape[1] - 1):
        lg, cache = step(jpk, jnp.asarray(want[:, i:i + 1]), cache)
    np.testing.assert_allclose(stats["last_logits"].numpy(),
                               np.asarray(lg[:, -1]), rtol=2 ** -7, atol=0)


def test_mixed_plan_pool_equals_lockstep(mixed):
    """The planned contiguous scheduler's tokens equal its lock-step
    waves (asserted inside serve_continuous) and lock-step serve's."""
    _, _, _, tparams, _, _ = mixed
    toks, stats = serve_continuous(
        "minicpm-2b", smoke=True, slots=2, prompt_len=8, n_requests=4,
        stop_lengths=(3, 6, 4), plan=T_MIXED, device="cpu", params=tparams)
    assert stats["tokens_match_lockstep"] and stats["cim"]
    assert stats["plan"] == T_MIXED.summary()
    assert sorted(toks) == [0, 1, 2, 3]
