"""Port parity: unpacked CIM execution (raw weights quantized per call),
``lm.forward`` and unpacked serving, against the reference package.

Raw weights go through the same macro arithmetic as a pack of them, so
every integer GEMM here is compared with ``==``: ``qat.cim_linear``,
``CimEngine.matmul`` / ``matmul_int`` on raw and packed weights, the
per-segment noise streams of a fused raw group, and the fast path of
design points outside the prepacked kernels' envelope (acc_len 12, a
top-7 split), with and without a noise key.  Noisy reference GEMMs run
under ``jax.jit``, as the reference serves them (tests/test_torch_noise.py).

``lm.forward`` is held to the reference's ``lm.forward(remat=False)``
on the minicpm-2b smoke model in four modes (float, the uniform
prototype, a mixed plan, noisy): the final hidden states with ``==``,
and the logits with ``==`` but for a counted residue (``LOGIT_RESIDUE``):
the lm_head's bf16 dot, whose float32 sum XLA's CPU GEMM orders by its
own blocking of K.  On an AVX512-BF16 host the port takes that order
(``layers.lm_head_order``, measured by ``tools/lm_head_dot_probe.py``)
and the residue is 0; elsewhere the port sums in torch's order and one
logit of 16,384 is one bf16 step apart in the float and noisy modes
(ROADMAP Queue 3 item 5), held to one bf16 rounding step (rtol 2^-7,
the repo's logit bound).  Unpacked forwards equal packed ones with
``==``, and unpacked serving gives the reference's ``serve(pack=False)``
tokens and the port's packed tokens, with and without analog noise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as JP
from repro.configs import get_config as jget
from repro.core import ccim as J
from repro.core import engine as JE
from repro.core import qat as JQ
from repro.core.ccim import DEFAULT_CONFIG as J_DEFAULT
from repro.launch.serve import serve as jserve
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.convert import macro_from_jax, params_from_jax, plan_from_jax
from repro_torch.core import ccim as T
from repro_torch.core import engine as TE
from repro_torch.core import qat as TQ
from repro_torch.core.ccim import DEFAULT_CONFIG
from repro_torch.kernels.ccim_matmul import kernel as K
from repro_torch.launch.serve import serve as tserve
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

SEGMENTS = (10, 6, 8)                      # of N = 24


def _key(seed: int, data: int):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


def _keys(n: int):
    ks = [_key(11, i) for i in range(n)]
    return tuple(k[0] for k in ks), tuple(k[1] for k in ks)


def _floats(seed=0, m=6, k=40, n=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, m // 2, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _ints(seed=0, m=6, k=40, n=24):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (m, k)).astype(np.int32),
            rng.integers(-127, 128, (k, n)).astype(np.int32))


def _cfgs(**kw):
    return (dataclasses.replace(J_DEFAULT, **kw),
            dataclasses.replace(DEFAULT_CONFIG, **kw))


# a mixed plan: a digital site, an analog-subset site, a hybrid5 site, a
# float site and an L32 default (tests/test_torch_plan.py's)
J_MIXED = JP.DeploymentPlan.from_dict({
    "mlp/w2": JP.DIGITAL_ENTRY,
    "attn/wq": JP.PlanEntry(cfg=dataclasses.replace(
        J_DEFAULT, n_dcim_products=0, adc_bits=8), label="analog0/adc8"),
    "attn/wo": JP.PlanEntry(cfg=dataclasses.replace(
        J_DEFAULT, n_dcim_products=5, adc_bits=8), label="hybrid5/adc8"),
    "mlp/w3": JP.FLOAT_ENTRY,
}, default=JP.PlanEntry(cfg=dataclasses.replace(J_DEFAULT, acc_len=32,
                                                adc_bits=8),
                        label="hybrid3/adc8/L32"))
T_MIXED = plan_from_jax(J_MIXED)

# design points: the prototype (kernel row 6's numerics), one inside the
# prepacked kernels' envelope, and two outside it
POINTS = [dict(), dict(acc_len=32, adc_bits=8), dict(acc_len=12),
          dict(n_dcim_products=7)]


# -- the engine --------------------------------------------------------------


@pytest.mark.parametrize("point", POINTS)
@pytest.mark.parametrize("noise", [None, "key", "segments"])
def test_cim_linear_equals_reference(point, noise):
    jc, tc = _cfgs(**point)
    x, w = _floats()
    jk = tk = None
    segs = None
    if noise == "key":
        jk, tk = _key(3, 1)
    elif noise == "segments":
        (jk, tk), segs = _keys(3), SEGMENTS
    want = jax.jit(lambda a, b, k: JQ.cim_linear(a, b, k, jc, "fast", False,
                                                 segs))(
        jnp.asarray(x), jnp.asarray(w), jk)
    got = TQ.cim_linear(torch.from_numpy(x), torch.from_numpy(w), tk, tc,
                        "fast", None, segs)
    assert got.shape == (2, 3, 24)
    assert np.array_equal(np.asarray(want), got.numpy())
    # raw == packed, through the engine
    eng = TE.CimEngine(cfg=tc)
    assert torch.equal(eng.matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  tk, segs),
                       eng.matmul(torch.from_numpy(x),
                                  eng.pack(torch.from_numpy(w)), tk, segs))


@pytest.mark.parametrize("point", POINTS)
@pytest.mark.parametrize("keyed", [False, True])
def test_out_of_envelope_and_packed_ints_equal_reference(point, keyed):
    """``matmul_int`` on raw ints and on a pack; outside the prepacked
    kernels' envelope the noise-free fast path is the chunked GEMM in
    torch (acc_len 12 packs K to whole chunks)."""
    jc, tc = _cfgs(**point)
    x, _ = _ints(1)
    _, w = _floats(1)
    jk, tk = _key(5, 2) if keyed else (None, None)
    jp = JE.pack_cim_weights(jnp.asarray(w), jc)
    tp = TE.pack_cim_weights(torch.from_numpy(w), tc)
    want = jax.jit(lambda a, k: JE.packed_cim_matmul_int(
        a, jp, None, jc, k))(jnp.asarray(x), jk)
    eng = TE.CimEngine(cfg=tc)
    K.reset_launch_counts()
    assert np.array_equal(np.asarray(want),
                          eng.matmul_int(torch.from_numpy(x), tp, tk).numpy())
    wq = tp.wq()
    want_raw = jax.jit(lambda a, b, k: J.cim_matmul_int(
        a, b, None, jc, k))(jnp.asarray(x), jnp.asarray(wq.numpy()), jk)
    assert np.array_equal(np.asarray(want_raw),
                          eng.matmul_int(torch.from_numpy(x), wq, tk).numpy())
    assert sum(c.launches for c in (K.ccim_matmul_unpacked_cuda,
                                    K.ccim_matmul_prepacked_skinny_cuda,
                                    K.ccim_matmul_prepacked_general_cuda)) == 0


@pytest.mark.parametrize("fidelity", ["exact", "fast_broadcast", "bit_true"])
def test_matmul_int_fidelities_and_die_equal_reference(fidelity):
    x, w = _ints(2, m=3, k=32, n=5)
    die = J.fabricate(jax.random.PRNGKey(4))
    jeng = JE.CimEngine(fidelity=fidelity, macro=die)
    teng = TE.CimEngine(fidelity=fidelity,
                        macro=macro_from_jax(jax.tree.map(np.asarray, die),
                                             "cpu"))
    want = jeng.matmul_int(jnp.asarray(x), jnp.asarray(w))
    got = teng.matmul_int(torch.from_numpy(x), torch.from_numpy(w))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("fidelity", ["fast_broadcast", "bit_true"])
def test_segments_refused_off_fast_and_exact(fidelity):
    x, w = _ints(3, m=2, k=16, n=24)
    _, tk = _keys(3)
    for fn in (lambda: T.cim_matmul_int(torch.from_numpy(x),
                                        torch.from_numpy(w), noise_key=tk,
                                        fidelity=fidelity,
                                        noise_segments=SEGMENTS),
               lambda: TE.packed_cim_matmul_int(
                   torch.from_numpy(x),
                   TE.pack_cim_weights(torch.from_numpy(w).float()),
                   noise_key=tk, fidelity=fidelity,
                   noise_segments=SEGMENTS)):
        with pytest.raises(ValueError, match="per-segment noise"):
            fn()
    with pytest.raises(ValueError, match="per-segment noise"):
        J.cim_matmul_int(jnp.asarray(x), jnp.asarray(w), None,
                         noise_key=_keys(3)[0], fidelity=fidelity,
                         noise_segments=SEGMENTS)


def test_maybe_cim_linear_equals_reference():
    x, w = _floats(4)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for cfg in (None, J_DEFAULT):
        want = JQ.maybe_cim_linear(jnp.asarray(x), jnp.asarray(w), cfg)
        got = TQ.maybe_cim_linear(tx, tw, None if cfg is None
                                  else DEFAULT_CONFIG)
        assert np.array_equal(np.asarray(want), got.numpy())
    assert torch.equal(TQ.maybe_cim_linear(tx, TE.pack_cim_weights(tw), None),
                       TQ.maybe_cim_linear(tx, tw, DEFAULT_CONFIG))


# -- the model ---------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jget("minicpm-2b", smoke=True)
    tcfg = tget("minicpm-2b", smoke=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tcfg, "cpu")
    return jp, jcfg, tp, tcfg


MODES = {"float": dict(),
         "prototype": dict(cim_mode=True),
         "mixed": dict(cim_mode=True, cim_plan="mixed"),
         "noisy": dict(cim_mode=True, cim_noise_seed=5)}
# logits more than 0 of 16,384 apart, by mode (the module docstring)
LOGIT_RESIDUE = ({"float": 0, "prototype": 0, "mixed": 0, "noisy": 0}
                 if tL.bf16_dot_host() else
                 {"float": 1, "prototype": 0, "mixed": 0, "noisy": 1})


def _mode_cfgs(jcfg, tcfg, mode):
    kw = dict(MODES[mode])
    jk, tk = dict(kw), dict(kw)
    if "cim_plan" in kw:
        jk["cim_plan"], tk["cim_plan"] = J_MIXED, T_MIXED
    return dataclasses.replace(jcfg, **jk), dataclasses.replace(tcfg, **tk)


def test_iter_packable_paths_equal_reference(models):
    jp, _, tp, tcfg = models
    assert tlm.iter_packable_paths(tp) == jlm.iter_packable_paths(jp)
    assert list(tlm.iter_packable_paths(tp)) == list(
        jlm.iter_packable_paths(jp))
    assert set(tlm._walk_packable(tp, lambda p, v: p)["layers"]["attn"]
               .values()) == {"attn/wq", "attn/wk", "attn/wv", "attn/wo"}


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_equals_reference_and_packed(models, mode):
    jp, jcfg, tp, tcfg = models
    jc, tc = _mode_cfgs(jcfg, tcfg, mode)
    toks = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(
        np.int32)
    jh, _ = jlm.hidden_states(jp, jc, jnp.asarray(toks), remat=False)
    jl, jaux = jlm.forward(jp, jc, jnp.asarray(toks), remat=False)
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        th, _ = tlm.hidden_states(tp, tc, tt)
        tl, taux = tlm.forward(tp, tc, tt, remat=False)
    assert np.array_equal(np.asarray(jh.astype(jnp.float32)),
                          th.float().numpy())
    jl = np.asarray(jl)
    assert tl.shape == (2, 16, 512) and tl.dtype == torch.float32
    assert float(taux) == float(jaux) == 0.0
    n_diff = int((tl.numpy() != jl).sum())
    assert n_diff <= LOGIT_RESIDUE[mode], n_diff
    np.testing.assert_allclose(tl.numpy(), jl, rtol=2 ** -7, atol=0)
    if tc.cim_mode:
        with torch.inference_mode():
            packed, _ = tlm.forward(tlm.pack_cim_params(tp, tc, "cpu"), tc,
                                    tt)
        assert torch.equal(packed, tl)


def test_unfused_raw_forward_equals_fused(models):
    _, _, tp, tcfg = models
    tc = dataclasses.replace(tcfg, cim_mode=True, cim_noise_seed=2)
    tt = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (1, 12))).long()
    with torch.inference_mode():
        fused, _ = tlm.forward(tp, tc, tt)
        unfused, _ = tlm.forward(tp, dataclasses.replace(tc, cim_fuse=False),
                                 tt)
    assert torch.equal(fused, unfused)


@pytest.fixture(scope="module")
def reference_unpacked():
    """The reference's ``serve(pack=False)`` tokens, noise-free and at
    noise seed 0."""
    kw = dict(smoke=True, batch=2, prompt_len=8, gen=6, cim=True,
              pack=False)
    return (np.asarray(jserve("minicpm-2b", **kw)),
            np.asarray(jserve("minicpm-2b", noise_seed=0, **kw)))


@pytest.mark.parametrize("noise_seed", [None, 0])
def test_unpacked_serve_equals_reference_and_packed(models,
                                                    reference_unpacked,
                                                    noise_seed):
    _, _, tp, _ = models
    want = reference_unpacked[0 if noise_seed is None else 1]
    kw = dict(smoke=True, batch=2, prompt_len=8, gen=6, cim=True,
              device="cpu", params=tp, noise_seed=noise_seed)
    got, st = tserve("minicpm-2b", pack=False, return_stats=True, **kw)
    np.testing.assert_array_equal(got, want)
    assert st["packed"] is False and st["cim"] is True
    np.testing.assert_array_equal(tserve("minicpm-2b", **kw), got)
