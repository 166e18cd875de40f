"""Port parity: the SSM family (Mamba2 / SSD) on the mamba2-130m smoke
model, with weights from the reference ``lm.init`` (or ``mamba2_init``)
through ``convert.params_from_jax`` and inputs from numpy seeds.

``mamba2_apply`` is compared with the reference's under ``jax.jit``
(the compiled code serving runs) with ``==``: outputs, SSM state and
conv state, for prefill at one chunk, several chunks, a ragged length
and a length under one chunk, and for chained decode steps.  The port's
CPU path reproduces that code's float32 arithmetic: XLA's exp and log1p,
its blocked cumulative sum, its fused multiply-adds, its dots' lane
order, the bf16 rounding of every conv product and sum, and the
unrounded y * silu(z) that the gated norm reads (``models/layers.py``).
The gated norm takes XLA-CPU's rsqrt (the processor's estimate and a
Newton step, one float32 ulp off the correctly rounded value on 13 % of
inputs) from a measured table on an AVX-512 host (``layers.xla_rsqrt``,
ROADMAP Queue 3 item 1).  On another host it takes the correctly
rounded rsqrt, and a residue is counted (``NORM_RESIDUE``): one norm
output moved by one bf16 step, and out_proj's row with it, one of
24,576 outputs at three chunks, none in the other cases.  Those are
held to one bf16 step of the call's largest output.
The reference's own check that the chunked scan equals the step-by-step
recurrence runs on the port with its tolerance (rtol 2e-3, atol 2e-4:
the two evaluate the same sums in different orders).

Greedy tokens are compared with ``==`` in every serving mode: lock-step
in float, packed (fused and unfused) and unpacked CIM mode, the
scheduler's refilled pool against solo runs, and the paged pool with
chunked prefill against the contiguous one at temperature 0.7.  The
prefill's SSM and conv caches are compared with ``==``; the logits with
``==`` but for the counted lm_head residue of ROADMAP Queue 3 item 5
(``LOGIT_RESIDUE``, held to one bf16 step, rtol 2^-7: 0 on an
AVX512-BF16 host, where the port's head sums in XLA-CPU's order).  Each reference
scheduler runs once per module (a fixture).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as JP
from repro.configs import get_config as jget
from repro.launch import scheduler as JS
from repro.launch.paging import PagedLayout as JLayout
from repro.launch.serve import serve as jserve
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch import plan as TP
from repro_torch.configs import get_config as tget
from repro_torch.convert import (FLOAT32_LEAVES, params_from_jax,
                                 plan_from_jax)
from repro_torch.launch import plan_pareto
from repro_torch.launch import scheduler as TS
from repro_torch.launch.paging import PagedLayout as TLayout
from repro_torch.launch.serve import serve as tserve
from repro_torch.launch.serve import serve_speculative
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

ARCH = "mamba2-130m"
# forward logits more than 0 apart (of 2 x 16 x 512), by mode: the
# lm_head's float32 sum order (ROADMAP Queue 3 item 5)
LOGIT_RESIDUE = ({"float": 0, "prototype": 0} if tL.bf16_dot_host() else
                 {"float": 2, "prototype": 0})


def _f32(tree):
    return jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), tree)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=torch.bfloat16):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _bf16(rng, shape, scale=1.0):
    return _np(jnp.asarray(rng.standard_normal(shape) * scale)
               .astype(jnp.bfloat16))


@pytest.fixture(scope="module")
def layer():
    jcfg, tcfg = jget(ARCH, smoke=True), tget(ARCH, smoke=True)
    jp, _ = jL.mamba2_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    return jcfg, tcfg, jp, params_from_jax(_f32(jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jget(ARCH, smoke=True), tget(ARCH, smoke=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_f32(jp), tcfg, "cpu")


def _state(rng, cfg, B):
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    W = cfg.ssm_conv_width
    return ((rng.standard_normal((B, H, P, N)) * 0.3).astype(np.float32),
            _bf16(rng, (B, W - 1, cfg.d_inner)),
            _bf16(rng, (B, W - 1, 2 * N)))


def _assert_layer_equal(jout, tout, residue=0):
    jy, (jst, (jcx, jcb)) = jout
    ty, (tst, (tcx, tcb)) = tout
    got, want = ty.float().numpy(), _np(jy)
    assert int((got != want).sum()) <= residue
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tcx.float().numpy(), _np(jcx))
    np.testing.assert_array_equal(tcb.float().numpy(), _np(jcb))


# outputs apart by the gated norm's rsqrt, by prefill case (docstring)
NORM_RESIDUE = {32: 0, 96: 0 if tL.avx512f_host() else 1, 40: 0, 20: 0}


@pytest.mark.parametrize("S,from_state", [(32, False), (96, False),
                                          (40, True), (20, True)],
                         ids=["one_chunk", "three_chunks", "ragged",
                              "under_a_chunk"])
def test_mamba2_prefill_equals_reference(layer, S, from_state):
    """The chunked SSD prefill (S padded to a chunk multiple with dt = 0)
    from zeros or from a carried SSM state: ``==``."""
    jcfg, tcfg, jp, tp = layer
    rng = np.random.default_rng(S)
    x = _bf16(rng, (2, S, jcfg.d_model))
    st = _state(rng, jcfg, 2)[0] if from_state else None
    jf = jax.jit(lambda p, x, s: jL.mamba2_apply(p, x, jcfg, ssm_state=s))
    jout = jf(jp, jnp.asarray(x, jnp.bfloat16),
              None if st is None else jnp.asarray(st))
    tout = tL.mamba2_apply(tp, _t(x), tcfg,
                           ssm_state=None if st is None
                           else _t(st, torch.float32))
    _assert_layer_equal(jout, tout, NORM_RESIDUE[S])


def test_mamba2_decode_steps_equal_reference(layer):
    """Six chained single-step recurrences, each fed the previous step's
    SSM and conv state: every step ``==``."""
    jcfg, tcfg, jp, tp = layer
    rng = np.random.default_rng(7)
    st, cx, cb = _state(rng, jcfg, 3)
    jst, jcx, jcb = (jnp.asarray(st), jnp.asarray(cx, jnp.bfloat16),
                     jnp.asarray(cb, jnp.bfloat16))
    tst, tcx, tcb = _t(st, torch.float32), _t(cx), _t(cb)
    jf = jax.jit(lambda p, x, s, a, b: jL.mamba2_apply(
        p, x, jcfg, ssm_state=s, conv_state=(a, b), decode=True))
    for _ in range(6):
        x = _bf16(rng, (3, 1, jcfg.d_model))
        jout = jf(jp, jnp.asarray(x, jnp.bfloat16), jst, jcx, jcb)
        tout = tL.mamba2_apply(tp, _t(x), tcfg, ssm_state=tst,
                               conv_state=(tcx, tcb), decode=True)
        _assert_layer_equal(jout, tout)
        jst, (jcx, jcb) = jout[1]
        tst, (tcx, tcb) = tout[1]


def test_ssd_chunked_equals_recurrent():
    """The reference's check (tests/test_models.py) on the port: the
    chunked scan over 24 steps equals 24 single steps, at its own
    tolerance."""
    cfg = dataclasses.replace(
        tget(ARCH, smoke=True), n_layers=1, d_model=32, vocab_size=64,
        ssm_state=8, ssm_head_dim=8, ssm_chunk=8, dtype="float32")
    gen = torch.Generator().manual_seed(2)
    p = tlm._layer(tL.mamba2_init(gen, cfg, 1, torch.float32), 0)
    B, S = 2, 24
    x = torch.randn((B, S, cfg.d_model), generator=gen) * 0.5
    y_par, (state_par, _) = tL.mamba2_apply(p, x, cfg)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    W = cfg.ssm_conv_width
    state = torch.zeros((B, H, P, N))
    conv = (torch.zeros((B, W - 1, cfg.d_inner)),
            torch.zeros((B, W - 1, 2 * N)))
    outs = []
    for t in range(S):
        y, (state, conv) = tL.mamba2_apply(p, x[:, t:t + 1], cfg,
                                           ssm_state=state, conv_state=conv,
                                           decode=True)
        outs.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(state_par.numpy(), state.numpy(),
                               rtol=2e-3, atol=2e-4)


def test_params_from_jax_keeps_float32_leaves(model):
    _, _, jp, tp = model
    m = tp["layers"]["mamba"]
    for name, v in m.items():
        want = torch.float32 if name in FLOAT32_LEAVES else torch.bfloat16
        assert v.dtype == want, name
        assert jp["layers"]["mamba"][name].dtype == (
            jnp.float32 if name in FLOAT32_LEAVES else jnp.bfloat16), name
    # the Mamba2 leaves and the moe's router (tests/test_torch_moe.py)
    assert FLOAT32_LEAVES == {"A_log", "D_skip", "dt_bias", "router"}
    np.testing.assert_array_equal(m["A_log"].numpy(),
                                  np.asarray(jp["layers"]["mamba"]["A_log"]))


def test_iter_packable_paths_equal_reference(model):
    jcfg, tcfg, jp, tp = model
    sites = tlm.iter_packable_paths(tp)
    assert sites == jlm.iter_packable_paths(jp)
    assert list(sites) == list(jlm.iter_packable_paths(jp))
    assert set(sites) == {"mamba/w_z", "mamba/w_x", "mamba/w_bc",
                          "mamba/w_dt", "mamba/out_proj"}
    packed = tlm.pack_cim_params(tp, dataclasses.replace(tcfg, cim_mode=True),
                                 "cpu")
    fused = packed["layers"]["mamba"]["w_z+w_x+w_bc+w_dt"]
    assert fused.seg_dims == (256, 256, 32, 8)


def test_config_fields_equal_reference():
    for smoke in (False, True):
        j, t = jget(ARCH, smoke), tget(ARCH, smoke)
        assert (t.d_inner, t.ssm_heads) == (j.d_inner, j.ssm_heads)
    full, small = tget(ARCH), tget(ARCH, smoke=True)
    assert (full.n_layers, full.d_model, full.d_inner, full.ssm_state,
            full.ssm_head_dim, full.ssm_heads, full.ssm_conv_width,
            full.ssm_chunk, full.vocab_size) == (
        24, 768, 1536, 128, 64, 24, 4, 128, 50280)
    assert (small.d_model, small.d_inner, small.ssm_state,
            small.ssm_head_dim, small.ssm_chunk, small.n_layers) == (
        128, 256, 16, 32, 32, 2)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["fp", "packed_fused", "packed_unfused",
                                  "unpacked"])
def test_greedy_tokens_equal_reference_serve(seed, mode):
    kw = {"fp": dict(cim=False), "packed_fused": dict(cim=True),
          "packed_unfused": dict(cim=True, fuse=False),
          "unpacked": dict(cim=True, pack=False)}[mode]
    jp, _ = jlm.init(jax.random.PRNGKey(seed), jget(ARCH, smoke=True))
    want = jserve(ARCH, smoke=True, seed=seed, **kw)
    got = tserve(ARCH, smoke=True, seed=seed, device="cpu",
                 params=params_from_jax(_f32(jp), tget(ARCH, smoke=True),
                                        "cpu"), **kw)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("cim", [False, True])
def test_prefill_and_decode_caches_equal_reference(model, cim):
    """Prefill (24 tokens) then three decode steps through jitted
    ``lm.prefill``/``lm.decode_step`` and the port's: the SSM and conv
    caches and the positions ``==`` after each call, the logits ``==``
    but for the lm_head residue."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, cim_mode=cim)
    tcfg = dataclasses.replace(tcfg, cim_mode=cim)
    if cim:
        jp = jlm.pack_cim_params(jp, jcfg)
        tp = tlm.pack_cim_params(tp, tcfg, "cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (2, 24))
    jprefill = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))
    jdecode = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))
    jl, jc = jprefill(jp, jnp.asarray(toks), jlm.init_cache(jcfg, 2, 32))
    tc = tlm.init_cache(tcfg, 2, 32, device="cpu")
    assert set(tc) == set(jc) == {"pos", "ssm", "conv_x", "conv_bc"}
    tl, tc = tlm.prefill(tp, tcfg, torch.tensor(toks), tc)
    for step in range(4):
        for k in ("ssm", "conv_x", "conv_bc", "pos"):
            np.testing.assert_array_equal(tc[k].float().numpy(), _np(jc[k]),
                                          err_msg=f"{k} at call {step}")
        assert int((tl.numpy() != np.asarray(jl)).sum()) <= 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=2 ** -7, atol=0)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc)
        tl, tc = tlm.decode_step(tp, tcfg, torch.tensor(nxt), tc)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_live_mask_equals_reference(model, paged):
    """A pooled step with one frozen row: the reference holds a frozen
    row's SSM and conv state only in paged caches, and so does the port
    (``==`` against the jitted reference either way)."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(4)
    if paged:
        jc = jlm.init_paged_cache(jcfg, 2, 8, 4, 4)
        tc = tlm.init_paged_cache(tcfg, 2, 8, 4, 4, device="cpu")
    else:
        jc = jlm.init_cache(jcfg, 2, 8)
        tc = tlm.init_cache(tcfg, 2, 8, device="cpu")
    st, cx, cb = _state(rng, jcfg, 2)
    jc = dict(jc, ssm=jnp.broadcast_to(jnp.asarray(st), jc["ssm"].shape),
              conv_x=jnp.broadcast_to(jnp.asarray(cx, jnp.bfloat16),
                                      jc["conv_x"].shape),
              conv_bc=jnp.broadcast_to(jnp.asarray(cb, jnp.bfloat16),
                                       jc["conv_bc"].shape))
    for k in ("ssm", "conv_x", "conv_bc"):
        tc[k].copy_(torch.tensor(_np(jc[k])))
    before = {k: tc[k].clone() for k in ("ssm", "conv_x", "conv_bc")}
    live = np.array([True, False])
    tok = rng.integers(0, 512, (2, 1))
    _, jc = jax.jit(lambda p, t, c, l: jlm.decode_step(p, jcfg, t, c, l))(
        jp, jnp.asarray(tok), jc, jnp.asarray(live))
    _, tc = tlm.decode_step(tp, tcfg, torch.tensor(tok), tc,
                            live=torch.tensor(live))
    for k in ("ssm", "conv_x", "conv_bc", "pos"):
        np.testing.assert_array_equal(tc[k].float().numpy(), _np(jc[k]))
    for k, v in before.items():
        assert torch.equal(tc[k][:, 1], v[:, 1]) == paged, k
        assert not torch.equal(tc[k][:, 0], v[:, 0]), k


@pytest.mark.parametrize("mode", ["float", "prototype"])
def test_forward_equals_reference(model, mode):
    """``lm.forward`` (the planner's calibration forward): the final
    hidden states ``==``, the logits ``==`` but for the lm_head residue;
    packed == raw in CIM mode."""
    jcfg, tcfg, jp, tp = model
    cim = mode == "prototype"
    jcfg = dataclasses.replace(jcfg, cim_mode=cim)
    tcfg = dataclasses.replace(tcfg, cim_mode=cim)
    toks = np.random.default_rng(5).integers(0, 512, (2, 16))
    jh, _ = jax.jit(lambda p, t: jlm.hidden_states(p, jcfg, t, remat=False))(
        jp, jnp.asarray(toks))
    jl, _ = jax.jit(lambda p, t: jlm.forward(p, jcfg, t, remat=False))(
        jp, jnp.asarray(toks))
    with torch.inference_mode():
        th, _ = tlm.hidden_states(tp, tcfg, torch.tensor(toks))
        tl, _ = tlm.forward(tp, tcfg, torch.tensor(toks))
    np.testing.assert_array_equal(th.float().numpy(), _np(jh))
    n_diff = int((tl.numpy() != np.asarray(jl)).sum())
    assert n_diff <= LOGIT_RESIDUE[mode], n_diff
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2 ** -7,
                               atol=0)
    if cim:
        with torch.inference_mode():
            packed, _ = tlm.forward(tlm.pack_cim_params(tp, tcfg, "cpu"),
                                    tcfg, torch.tensor(toks))
        assert torch.equal(packed, tl)


def test_planned_ssm_family_packed_equals_unpacked(model):
    """The twin of tests/test_plan.py::test_planned_ssm_family:
    ``mamba/out_proj`` digital, the rest hybrid3/adc8/L32, noise seed 3;
    packed == unpacked, and the hidden states equal the reference's."""
    jcfg, tcfg, jp, tp = model
    from repro.core.ccim import DEFAULT_CONFIG as JD
    jplan = JP.DeploymentPlan.from_dict(
        {"mamba/out_proj": JP.DIGITAL_ENTRY},
        default=JP.PlanEntry(cfg=dataclasses.replace(JD, acc_len=32,
                                                     adc_bits=8),
                             fidelity="fast", label="hybrid3/adc8/L32"))
    jc = dataclasses.replace(jcfg, cim_mode=True, cim_plan=jplan,
                             cim_noise_seed=3)
    tc = dataclasses.replace(tcfg, cim_mode=True,
                             cim_plan=plan_from_jax(jplan), cim_noise_seed=3)
    toks = np.random.default_rng(6).integers(0, 512, (1, 16))
    with torch.inference_mode():
        u, _ = tlm.forward(tp, tc, torch.tensor(toks))
        q, _ = tlm.forward(tlm.pack_cim_params(tp, tc, "cpu"), tc,
                           torch.tensor(toks))
        th, _ = tlm.hidden_states(tp, tc, torch.tensor(toks))
    assert torch.equal(u, q)
    jh, _ = jax.jit(lambda p, t: jlm.hidden_states(p, jc, t, remat=False))(
        jp, jnp.asarray(toks))
    np.testing.assert_array_equal(th.float().numpy(), _np(jh))


def test_fused_forward_equals_unfused(model):
    """The twin of tests/test_fusion.py::test_fused_forward_bit_identical
    for mamba2: the fused input group == the four projections apart, raw
    and packed."""
    _, tcfg, _, tp = model
    on = dataclasses.replace(tcfg, cim_mode=True)
    off = dataclasses.replace(on, cim_fuse=False)
    toks = torch.tensor(np.random.default_rng(8).integers(0, 512, (1, 12)))
    with torch.inference_mode():
        ref, _ = tlm.forward(tp, off, toks)
        for params, cfg in ((tp, on), (tlm.pack_cim_params(tp, off, "cpu"),
                                       off),
                            (tlm.pack_cim_params(tp, on, "cpu"), on)):
            assert torch.equal(tlm.forward(params, cfg, toks)[0], ref)


# ---------------------------------------------------------------------------
# the scheduler: refill == solo, paged chunked == contiguous
# ---------------------------------------------------------------------------

P, CAP = 8, 6


def _jreqs(reqs):
    return [JS.Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens,
                       stop_token=r.stop_token) for r in reqs]


def _refill_requests():
    return TS.mixed_length_requests(6, P, 512, stop_lengths=(2, 6, 3, 5))


def _paged_requests():
    rng = np.random.default_rng(4)
    return [TS.Request(rid=i, prompt=rng.integers(0, 512, 16,
                                                  dtype=np.int32),
                       max_new_tokens=(6, 9)[i % 2], stop_token=3)
            for i in range(4)]


@pytest.fixture(scope="module")
def ref_runs(model):
    """The reference's refilled pool (float weights, 2 slots) and its
    contiguous pool at T 0.7 (the paged test's baseline)."""
    jcfg, _, jp, _ = model
    refill = JS.ContinuousBatchingScheduler(
        jp, jcfg, slots=2, prompt_len=P, max_new_cap=CAP).run(
        _jreqs(_refill_requests()))
    sampled = JS.ContinuousBatchingScheduler(
        jp, jcfg, slots=2, prompt_len=16, max_new_cap=10, temperature=0.7,
        seed=5).run(_jreqs(_paged_requests()))
    return refill.tokens_by_rid(), sampled.tokens_by_rid()


def _assert_tokens_equal(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_refill_equals_solo_and_reference(model, ref_runs):
    """Three times more requests than slots: every slot is refilled
    mid-stream, and each request's tokens equal its solo run and the
    reference's pool (tests/test_scheduler.py's refill test)."""
    _, tcfg, _, tp = model
    reqs = _refill_requests()
    pool = TS.ContinuousBatchingScheduler(tp, tcfg, slots=2, prompt_len=P,
                                          max_new_cap=CAP)
    report = pool.run(reqs)
    assert report.n_admits == len(reqs)
    got = report.tokens_by_rid()
    _assert_tokens_equal(got, ref_runs[0])
    solo = TS.ContinuousBatchingScheduler(tp, tcfg, slots=1, prompt_len=P,
                                          max_new_cap=CAP)
    for r in reqs:
        np.testing.assert_array_equal(
            solo.run([r]).tokens_by_rid()[r.rid], got[r.rid])


def test_paged_chunked_equals_contiguous_sampled(model, ref_runs):
    """The paged pool with chunked prefill (chunk 8, prompts 16) at T 0.7:
    the recurrent state rides per-slot dense buffers, pool steps between
    a slot's chunks must not touch it, and the tokens equal the
    contiguous pool's and the reference's (tests/test_paging.py)."""
    _, tcfg, _, tp = model
    kw = dict(slots=2, prompt_len=16, max_new_cap=10, temperature=0.7,
              seed=5)
    reqs = _paged_requests()
    want = TS.ContinuousBatchingScheduler(tp, tcfg, **kw).run(
        reqs).tokens_by_rid()
    _assert_tokens_equal(want, ref_runs[1])
    sched = TS.ContinuousBatchingScheduler(
        tp, tcfg, paged=TLayout(4, 10, 40), prefill_chunk=8, **kw)
    rep = sched.run(reqs)
    _assert_tokens_equal(rep.tokens_by_rid(), want)
    assert rep.ref_final.tolist() == [1] + [0] * 39
    assert sched.kv_bytes_paged() == 0
    assert TLayout(4, 10, 40).kv_bytes(tcfg) == JLayout(4, 10, 40).kv_bytes(
        jget(ARCH, smoke=True)) == 0


def test_ssm_scheduler_rules(model):
    """The reference's SSM rules: no speculative rounds, paged prompts a
    whole number of prefill chunks, no prefix sharing."""
    _, tcfg, _, tp = model
    with pytest.raises(NotImplementedError, match="recurrent"):
        TS.ContinuousBatchingScheduler(tp, tcfg, slots=2, prompt_len=8,
                                       max_new_cap=4, draft_k=4)
    sched = TS.ContinuousBatchingScheduler(
        tp, tcfg, slots=2, prompt_len=16, max_new_cap=4,
        paged=TLayout(4, 6, 24), prefill_chunk=8)
    short = TS.Request(rid=0, prompt=np.arange(12, dtype=np.int32),
                       max_new_tokens=4)
    with pytest.raises(ValueError, match="multiple of prefill_chunk"):
        sched.run([short])
    # four prompts of 16 sharing their first 8 tokens (two blocks)
    rng = np.random.default_rng(2)
    head = rng.integers(0, 512, 8, dtype=np.int32)
    shared = [TS.Request(rid=i, prompt=np.concatenate(
        [head, rng.integers(0, 512, 8, dtype=np.int32)]), max_new_tokens=3)
        for i in range(4)]
    sched.run(shared)
    assert sched.last_prefix_plan.stats()["shared_blocks"] == 0


def test_speculative_paths_refuse_ssm(model):
    _, tcfg, _, tp = model
    with pytest.raises(NotImplementedError, match="recurrent"):
        serve_speculative(ARCH, smoke=True, device="cpu", gen=4)
    cache = tlm.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="recurrent"):
        tlm.verify_step(tp, tcfg, torch.zeros((1, 3), dtype=torch.int64),
                        cache)


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen3-14b",
                                  "starcoder2-7b", "gemma2-9b", "mamba2-130m",
                                  "qwen2-moe-a2.7b", "arctic-480b",
                                  "paligemma-3b", "zamba2-1.2b",
                                  "musicgen-medium"])
def test_registry_resolves_arch_to_reference_config(arch):
    """Every arch of the reference resolves in the port's registry, full
    and smoke, to a config equal to the reference's field for field (the
    port-only kernel routing fields aside), of a family ``lm`` serves."""
    for smoke in (False, True):
        t, j = tget(arch, smoke), jget(arch, smoke)
        for f in dataclasses.fields(t):
            if f.name not in ("cim_use_kernel", "paged_attn_use_kernel"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        tlm.check_family(t)


def test_plan_pareto_twin_second_arch(model):
    """The twin's mamba2-130m arch at smoke size: the five mamba sites,
    four points, decode tok/s served packed under three plans, and the
    planned point not dominated."""
    _, tcfg, _, tp = model
    cands = [TP.digital_candidate(), TP.prototype_candidate()]
    out = plan_pareto.run_arch(ARCH, smoke=True, batch=1, prompt_len=8,
                               gen=3, device="cpu", params=tp,
                               candidates=cands)
    assert list(out["sites"]) == list(tlm.iter_packable_paths(tp))
    assert out["sites"]["mamba/out_proj"] == tcfg.n_layers * 256 * 128
    pts = out["points"]
    for name in ("global_digital", "global_hybrid", "planned_mixed"):
        assert pts[name]["decode_tok_s"] > 0
    assert pts["global_digital"]["combined"] == 1.0
    assert not out["planned_dominated_by_global_hybrid"]
    assert plan_pareto.BENCH_ARCHS == ("minicpm-2b", ARCH)
