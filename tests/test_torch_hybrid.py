"""Port parity: the hybrid family on the zamba2-1.2b smoke model (4 Mamba2
layers, the shared attn + mlp block after layers 2 and 4) and on a
5-layer variant (``SMOKE.reduced(n_layers=5)``: a remainder group of one
layer follows the last invocation), with weights from the reference
``lm.init`` through ``convert.params_from_jax`` and inputs from numpy
seeds.

The shared block's sites carry the prefix "shared/" into the plan and
the noise keys, its KV lives in ``shared_k`` / ``shared_v`` (one entry
per invocation, contiguous or paged), and where the block is the last op
of the stack the reference's compiled step feeds its float32 residual
sum to the final norm unrounded (``lm._attn_block(unrounded=True)``;
the prefill's slice of the last position stands between them, and there
the sum is rounded).

Compared with ``==``: hidden states, caches and logits of prefill and
decode in CIM mode, greedy tokens in every serving mode (float, packed
fused and unfused, unpacked, a noisy one), the scheduler's refilled pool
against solo runs and the reference, the paged pool with chunked prefill
against the contiguous one at temperature 0.7 (the serving modes in
``test_torch_hybrid_serve.py``, the scheduler in
``test_torch_hybrid_scheduler.py``).  Counted residues, each
held to one bf16 step of the largest value (rtol 2^-7 or atol 2^-7
max|ref|), as the dense family's prefill test holds them:

- ``LOGIT_RESIDUE``, ``LIVE_LOGIT_RESIDUE``: the lm_head's float32
  sums (ROADMAP Queue 3 item 5), in ``lm.forward`` and on the frozen row
  of a paged pooled step: 0 on an AVX512-BF16 host, where the port's
  head sums in XLA-CPU's order (``layers.lm_head_order``).
- ``FLOAT_PREFILL_RESIDUE``: in float mode (no CIM) the shared block's
  flash prefill.  XLA-CPU computes the block's bf16 score and P.V dots
  with a pair-wise bf16 dot (odd product first, the VDPBF16PS / AMX
  order) at some shapes and with 2-lane f32 sums at others.  On an
  AVX512-BF16 host the port's CPU flash takes the same order by shape
  (``layers.flash_orders``) and the caches and logits are ``==`` (the
  lm_head in XLA-CPU's order too); elsewhere it sums in its own order, and a score one float32
  ulp apart moves a bf16 output now and then (the counts measured with
  that order).  Everything upstream of the first invocation's attention
  is ``==`` (group 0's states, the first invocation's keys and values);
  downstream the caches differ by at most one bf16 step.  In CIM mode
  the int8 activation quantization absorbs these and the caches are
  ``==`` (ROADMAP Queue 3 item 8).

"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as JP
from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro_torch import plan as TP
from repro_torch.configs import get_config as tget
from repro_torch.convert import (packed_from_jax, params_from_jax,
                                 plan_from_jax)
from repro_torch.core.engine import FusedPackedCimWeights
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.plan import profiler as TPR

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

ARCH = "zamba2-1.2b"
# forward logits more than 0 apart (of 2 x 16 x 512), by (layers, mode):
# the lm_head's float32 sum order (ROADMAP Queue 3 item 5)
LOGIT_RESIDUE = ({(4, "float"): 0, (4, "prototype"): 0, (5, "float"): 0,
                  (5, "prototype"): 0} if TL.bf16_dot_host() else
                 {(4, "float"): 1, (4, "prototype"): 2, (5, "float"): 0,
                  (5, "prototype"): 0})
# logits of the FROZEN row (discarded by every caller) apart in a paged
# pooled step, by paged: the lm_head's float32 sum order of the
# reference's step with the masked state holds (Queue 3 item 5)
LIVE_LOGIT_RESIDUE = ({False: 0, True: 0} if TL.bf16_dot_host() else
                      {False: 0, True: 1})
# float-mode prefill (2 x 24 tokens, cache 32) values apart downstream of
# the first shared block (docstring), by entry
FLOAT_PREFILL_RESIDUE = ({"ssm": 0, "shared_k": 0, "shared_v": 0,
                          "logits": 0} if TL.bf16_dot_host() else
                         {"ssm": 4766, "shared_k": 590, "shared_v": 561,
                          "logits": 603})


def _f32(tree):
    return jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), tree)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _cfgs(n_layers=None):
    jcfg, tcfg = jget(ARCH, smoke=True), tget(ARCH, smoke=True)
    if n_layers is not None:
        jcfg, tcfg = jcfg.reduced(n_layers=n_layers), tcfg.reduced(
            n_layers=n_layers)
    return jcfg, tcfg


def _model(n_layers=None, seed=0):
    jcfg, tcfg = _cfgs(n_layers)
    jp, _ = jlm.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_f32(jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def model5():
    return _model(5)


@pytest.fixture(params=[4, 5], ids=["smoke", "five_layers"])
def either(request, model, model5):
    return model if request.param == 4 else model5


# ---------------------------------------------------------------------------
# config, params, packing
# ---------------------------------------------------------------------------


def test_config_fields_equal_reference():
    for smoke in (False, True):
        j, t = jget(ARCH, smoke), tget(ARCH, smoke)
        for f in dataclasses.fields(t):
            if f.name not in ("cim_use_kernel", "paged_attn_use_kernel"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert (t.d_inner, t.ssm_heads, t.padded_heads) == (
            j.d_inner, j.ssm_heads, j.padded_heads)
    full = tget(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.d_inner,
            full.ssm_heads, full.ssm_head_dim, full.ssm_state,
            full.ssm_conv_width, full.ssm_chunk, full.n_heads,
            full.head_dim, full.d_ff, full.shared_attn_period,
            full.vocab_size, full.tie_embeddings) == (
        "hybrid", 38, 2048, 4096, 64, 64, 64, 4, 128, 32, 64, 8192, 6,
        32000, False)
    assert tlm.n_shared_invocations(full) == 6
    assert tlm._groups(full)[-1] == (36, 38, None)
    small = tget(ARCH, smoke=True)
    assert (small.n_layers, small.shared_attn_period) == (4, 2)
    assert tlm._groups(small) == [(0, 2, 0), (2, 4, 1)]
    assert tlm._groups(small.reduced(n_layers=5))[-1] == (4, 5, None)


def test_params_from_jax_carries_the_shared_block(model):
    _, tcfg, jp, tp = model
    assert set(tp["shared"]) == {"attn", "mlp", "ln1", "ln2"}
    for part in ("attn", "mlp"):
        for name, v in tp["shared"][part].items():
            want = np.asarray(jp["shared"][part][name].astype(jnp.float32))
            assert v.dim() == 2 and v.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(v.float().numpy(), want)
    # the port's own init makes the same tree, shapes and dtypes
    own = tlm.init(0, tcfg, device="cpu")
    assert _leaves(own) == _leaves(tp)


def _leaves(tree, path=""):
    """path -> (shape, dtype) of every tensor leaf of a params tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{path}{k}/"))
        else:
            out[path + k] = (tuple(v.shape), v.dtype)
    return out


def test_iter_packable_paths_and_pack_equal_reference(either):
    jcfg, tcfg, jp, tp = either
    sites = tlm.iter_packable_paths(tp)
    assert sites == jlm.iter_packable_paths(jp)
    shared = {s: v for s, v in sites.items() if s.startswith("shared/")}
    assert shared == {
        "shared/attn/wq": (128, 128), "shared/attn/wk": (128, 128),
        "shared/attn/wv": (128, 128), "shared/attn/wo": (128, 128),
        "shared/mlp/w1": (128, 256), "shared/mlp/w3": (128, 256),
        "shared/mlp/w2": (256, 128)}
    jc = dataclasses.replace(jcfg, cim_mode=True)
    tc = dataclasses.replace(tcfg, cim_mode=True)
    jpk = jax.tree.map(np.asarray, jlm.pack_cim_params(jp, jc)["shared"])
    tpk = tlm.pack_cim_params(tp, tc, "cpu")["shared"]
    for part, key, segs in (("attn", "wq+wk+wv", (128, 128, 128)),
                            ("mlp", "w1+w3", (256, 256))):
        leaf = tpk[part][key]
        assert isinstance(leaf, FusedPackedCimWeights)
        assert leaf.seg_dims == segs and leaf.packed.kernel_w.dim() == 2
        want = packed_from_jax(jpk[part][key], "cpu")
        assert torch.equal(leaf.packed.kernel_w, want.packed.kernel_w)
        assert torch.equal(leaf.packed.kernel_planes,
                           want.packed.kernel_planes)
        assert torch.equal(leaf.packed.scale, want.packed.scale)
    for part, key in (("attn", "wo"), ("mlp", "w2")):
        want = packed_from_jax(jpk[part][key], "cpu")
        assert torch.equal(tpk[part][key].kernel_w, want.kernel_w)
        assert torch.equal(tpk[part][key].kernel_planes, want.kernel_planes)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["float", "prototype"])
def test_forward_equals_reference(either, mode):
    """``lm.forward``: the final hidden states ``==``, the logits ``==``
    but for the counted lm_head residue; packed == raw in CIM mode."""
    jcfg, tcfg, jp, tp = either
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
    assert n_diff <= LOGIT_RESIDUE[(tcfg.n_layers, mode)], n_diff
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2 ** -7,
                               atol=0)
    if cim:
        with torch.inference_mode():
            packed, _ = tlm.forward(tlm.pack_cim_params(tp, tcfg, "cpu"),
                                    tcfg, torch.tensor(toks))
        assert torch.equal(packed, tl)


CACHE_KEYS = ("pos", "ssm", "conv_x", "conv_bc", "shared_k", "shared_v")


@pytest.mark.parametrize("n_layers", [4, 5])
def test_prefill_and_decode_caches_equal_reference_cim(model, model5,
                                                       n_layers):
    """CIM mode, packed: prefill (24 tokens) then three decode steps
    through the jitted reference and the port: every cache entry and the
    logits ``==`` after each call."""
    jcfg, tcfg, jp, tp = model if n_layers == 4 else model5
    jcfg = dataclasses.replace(jcfg, cim_mode=True)
    tcfg = dataclasses.replace(tcfg, cim_mode=True)
    jp = jlm.pack_cim_params(jp, jcfg)
    tp = tlm.pack_cim_params(tp, tcfg, "cpu")
    toks = np.random.default_rng(3).integers(0, 512, (2, 24))
    jl, jc = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))(
        jp, jnp.asarray(toks), jlm.init_cache(jcfg, 2, 32))
    tc = tlm.init_cache(tcfg, 2, 32, device="cpu")
    assert set(tc) == set(jc) == set(CACHE_KEYS)
    assert tc["shared_k"].shape == (n_layers // 2, 2, 32, 4, 32)
    tl, tc = tlm.prefill(tp, tcfg, torch.tensor(toks), tc)
    jdecode = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))
    for step in range(4):
        for k in CACHE_KEYS:
            np.testing.assert_array_equal(tc[k].float().numpy(), _np(jc[k]),
                                          err_msg=f"{k} at call {step}")
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc)
        tl, tc = tlm.decode_step(tp, tcfg, torch.tensor(nxt), tc)


def test_prefill_caches_float_mode_residue(model):
    """Float mode (no CIM): ``==`` up to the first invocation's attention
    (group 0's SSM and conv states, the first invocation's keys and
    values, every conv state), then the counted residue of the shared
    block's flash prefill (docstring), each value within one bf16 step of
    the entry's largest."""
    jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(3).integers(0, 512, (2, 24))
    jl, jc = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))(
        jp, jnp.asarray(toks), jlm.init_cache(jcfg, 2, 32))
    tl, tc = tlm.prefill(tp, tcfg, torch.tensor(toks),
                         tlm.init_cache(tcfg, 2, 32, device="cpu"))
    p = tcfg.shared_attn_period
    for k in ("conv_x", "conv_bc", "pos"):
        np.testing.assert_array_equal(tc[k].float().numpy(), _np(jc[k]))
    np.testing.assert_array_equal(tc["ssm"][:p].numpy(), _np(jc["ssm"][:p]))
    for k in ("shared_k", "shared_v"):
        np.testing.assert_array_equal(tc[k][0].float().numpy(),
                                      _np(jc[k][0]))
    got = {k: tc[k].float().numpy() for k in ("ssm", "shared_k",
                                              "shared_v")}
    got["logits"] = tl.numpy()
    want = {k: _np(jc[k]) for k in ("ssm", "shared_k", "shared_v")}
    want["logits"] = np.asarray(jl)
    for k, n in FLOAT_PREFILL_RESIDUE.items():
        assert int((got[k] != want[k]).sum()) <= n, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=2 ** -7 * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_live_mask_equals_reference(model, paged):
    """A pooled CIM step with one frozen row, from a prefilled cache: the
    reference holds a frozen row's SSM and conv state only in paged
    caches, where its shared-KV write goes to the trash block; the port
    does the same (``==`` against the jitted reference either way)."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, cim_mode=True)
    tcfg = dataclasses.replace(tcfg, cim_mode=True)
    jp = jlm.pack_cim_params(jp, jcfg)
    tp = tlm.pack_cim_params(tp, tcfg, "cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 512, (2, 8))
    if paged:
        jc = jlm.init_paged_cache(jcfg, 2, 8, 4, 4)
        tc = tlm.init_paged_cache(tcfg, 2, 8, 4, 4, device="cpu")
        table = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
        jc = dict(jc, table=jnp.asarray(table))
        tc["table"].copy_(torch.tensor(table))
        assert tc["shared_k"].shape == (2, 8, 4, 4, 32)
    else:
        jc = jlm.init_cache(jcfg, 2, 12)
        tc = tlm.init_cache(tcfg, 2, 12, device="cpu")
    _, jc = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))(
        jp, jnp.asarray(toks), jc)
    _, tc = tlm.prefill(tp, tcfg, torch.tensor(toks), tc)
    before = {k: tc[k].clone() for k in ("ssm", "conv_x", "conv_bc")}
    live = np.array([True, False])
    tok = rng.integers(0, 512, (2, 1))
    jl, jc = jax.jit(lambda p, t, c, l: jlm.decode_step(p, jcfg, t, c, l))(
        jp, jnp.asarray(tok), jc, jnp.asarray(live))
    tl, tc = tlm.decode_step(tp, tcfg, torch.tensor(tok), tc,
                             live=torch.tensor(live))
    want = np.asarray(jl)
    np.testing.assert_array_equal(tl.numpy()[0], want[0])
    n_diff = int((tl.numpy() != want).sum())
    assert n_diff <= LIVE_LOGIT_RESIDUE[paged], n_diff
    np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
    for k in CACHE_KEYS:
        np.testing.assert_array_equal(tc[k].float().numpy(), _np(jc[k]),
                                      err_msg=k)
    for k, v in before.items():
        assert torch.equal(tc[k][:, 1], v[:, 1]) == paged, k
        assert not torch.equal(tc[k][:, 0], v[:, 0]), k
    if paged:      # the frozen row wrote its shared KV into the trash block
        assert tc["shared_k"][:, 0].abs().sum() > 0
        assert tc["shared_k"][:, 6].abs().sum() == 0


def test_shared_block_paths_reach_plan_and_noise(model):
    """The shared block resolves its own plan entries and noise keys: a
    plan that keeps ``shared/mlp/w2`` digital and runs the rest at
    hybrid3/adc8/L32, noise seed 3: the hidden states equal the
    reference's, packed == unpacked, and differ from a plan that names
    ``mlp/w2`` instead (the path the block would resolve without its
    prefix)."""
    jcfg, tcfg, jp, tp = model
    from repro.core.ccim import DEFAULT_CONFIG as JD

    def plans(site):
        jplan = JP.DeploymentPlan.from_dict(
            {site: JP.DIGITAL_ENTRY},
            default=JP.PlanEntry(cfg=dataclasses.replace(JD, acc_len=32,
                                                         adc_bits=8),
                                 fidelity="fast", label="hybrid3/adc8/L32"))
        return (dataclasses.replace(jcfg, cim_mode=True, cim_plan=jplan,
                                    cim_noise_seed=3),
                dataclasses.replace(tcfg, cim_mode=True,
                                    cim_plan=plan_from_jax(jplan),
                                    cim_noise_seed=3))
    toks = np.random.default_rng(6).integers(0, 512, (1, 16))
    jc, tc = plans("shared/mlp/w2")
    with torch.inference_mode():
        th, _ = tlm.hidden_states(tp, tc, torch.tensor(toks))
        q, _ = tlm.hidden_states(tlm.pack_cim_params(tp, tc, "cpu"), tc,
                                 torch.tensor(toks))
        other, _ = tlm.hidden_states(tp, plans("mlp/w2")[1],
                                     torch.tensor(toks))
    assert torch.equal(th, q)
    assert not torch.equal(th, other)
    jh, _ = jax.jit(lambda p, t: jlm.hidden_states(p, jc, t, remat=False))(
        jp, jnp.asarray(toks))
    np.testing.assert_array_equal(th.float().numpy(), _np(jh))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def test_shared_block_macs_count_per_group_execution(model):
    """The twin of tests/test_plan.py::
    test_shared_block_macs_count_per_group_execution: the shared block's
    weights park once but run once per invocation, so its MACs per token
    scale with the invocations and its area does not."""
    jcfg, tcfg, jp, tp = model
    sites = ["shared/attn/wq", "mamba/w_z"]
    toks = torch.tensor(np.random.default_rng(0).integers(0, 512, (2, 16)))
    prof = TPR.profile_sensitivities(tp, tcfg, toks,
                                     [TP.prototype_candidate()], sites=sites)
    n_inv = tlm.n_shared_invocations(tcfg)
    assert n_inv == jcfg.n_layers // jcfg.shared_attn_period == 2
    shapes = jlm.iter_packable_paths(jp)
    for s in sites:
        assert prof.weights_per_site(s) == int(np.prod(shapes[s]))
    assert (prof.macs_per_token("shared/attn/wq")
            == n_inv * prof.weights_per_site("shared/attn/wq"))
    assert (prof.macs_per_token("mamba/w_z")
            == prof.weights_per_site("mamba/w_z"))
