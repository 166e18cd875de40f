"""Port parity: the macro fidelities of repro_torch/core (elementwise
models, the fabricated die, the SAR ADC, 'fast_broadcast' / 'bit_true' /
'exact' GEMMs, raw and packed, the complex four-GEMM fallback), the
baselines and the cost model, against the reference on the same numpy
inputs.

Every integer output is compared with ``==``.  A fabricated die is drawn
by the reference (``jax.random``) and carried across with
``convert.macro_from_jax``: the two generators give different streams.
The bit-true model's analog sum ``a_real`` is a float32 sum of 784
mismatched cap weights whose last bit depends on the order of the sum,
and the die's mismatched SAR thresholds can turn that bit into a code;
the port sums in the reference's compiled order (term by term, in
(l, j, k) order), so with a fabricated die too ``a_real`` is compared
with ``==`` and the count of differing codes is 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as Jb
from repro.core import ccim as Jc
from repro.core import complex_mac as Jx
from repro.core import costmodel as Jcost
from repro.core import engine as Je
from repro_torch import convert
from repro_torch.core import baselines as Tb
from repro_torch.core import ccim as Tc
from repro_torch.core import complex_mac as Tx
from repro_torch.core import costmodel as Tcost
from repro_torch.core import engine as Te

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

CONFIGS = {
    "prototype": {},
    "all_analog": dict(n_dcim_products=0, adc_bits=8),
    "top6_adc8_L8": dict(n_dcim_products=6, adc_bits=8, acc_len=8),
    "per_macro_averaged": dict(mismatch_granularity="per_macro",
                               adc_mismatch_model="averaged",
                               use_split_dac=False),
}


def _cfgs(name):
    kw = CONFIGS[name]
    return Jc.CCIMConfig(**kw), Tc.CCIMConfig(**kw)


def _ints(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _die(jcfg, seed):
    jm = Jc.fabricate(jax.random.PRNGKey(seed), jcfg)
    return jm, convert.macro_from_jax(jax.tree_util.tree_map(np.asarray, jm),
                                      "cpu")


def _assert_dict_equal(jd, td):
    assert set(jd) == set(td)
    for k in jd:
        np.testing.assert_array_equal(np.asarray(jd[k]), td[k].numpy(),
                                      err_msg=k)


def test_bit_planes_and_tables():
    rng = np.random.default_rng(0)
    q = _ints(rng, (5, 16))
    np.testing.assert_array_equal(
        np.asarray(Jc.bit_planes(jnp.abs(jnp.asarray(q)), 7)),
        Tc.bit_planes(_t(np.abs(q)), 7).numpy())
    jc, tc = _cfgs("prototype")
    np.testing.assert_array_equal(
        np.asarray(Jc._signed_bits(jnp.asarray(q), jc)),
        Tc._signed_bits(_t(q), tc).numpy())
    for name in CONFIGS:
        jc, tc = _cfgs(name)
        np.testing.assert_array_equal(jc.dcim_weight_table(),
                                      tc.dcim_weight_table())
        np.testing.assert_array_equal(jc.acim_weight_table(),
                                      tc.acim_weight_table())
        np.testing.assert_array_equal(Jc.contribution_table(jc),
                                      Tc.contribution_table(tc))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_elementwise_models(name):
    """hybrid_mac_ideal, the noise-free hybrid_mac_fast and bit-true on
    the ideal die; on the ideal die every term is an exact integer."""
    jc, tc = _cfgs(name)
    rng = np.random.default_rng(len(name))
    x, w = _ints(rng, (300, jc.acc_len)), _ints(rng, (300, jc.acc_len))
    np.testing.assert_array_equal(
        np.asarray(Jc.hybrid_mac_ideal(jnp.asarray(x), jnp.asarray(w), jc)),
        Tc.hybrid_mac_ideal(_t(x), _t(w), tc).numpy())
    _assert_dict_equal(
        Jc.hybrid_mac_fast(jnp.asarray(x), jnp.asarray(w), None, jc),
        Tc.hybrid_mac_fast(_t(x), _t(w), None, tc))
    jd = Jc.hybrid_mac_bit_true(jnp.asarray(x), jnp.asarray(w),
                                Jc.ideal_macro(jc), jc)
    td = Tc.hybrid_mac_bit_true(_t(x), _t(w), Tc.ideal_macro(tc), tc)
    _assert_dict_equal(jd, td)
    # ideal die == the rounding floor
    assert torch.equal(td["y8"], Tc.hybrid_mac_ideal(_t(x), _t(w), tc))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bit_true_fabricated_die(name):
    """A reference-fabricated die carried across: every output, a_real
    included, equal -- 0 of 4,000 codes differ (jitted reference)."""
    jc, tc = _cfgs(name)
    rng = np.random.default_rng(7)
    x, w = _ints(rng, (4000, jc.acc_len)), _ints(rng, (4000, jc.acc_len))
    for seed in (1, 2):
        jm, tm = _die(jc, seed)
        jd = jax.jit(lambda a, b: Jc.hybrid_mac_bit_true(a, b, jm, jc))(
            jnp.asarray(x), jnp.asarray(w))
        td = Tc.hybrid_mac_bit_true(_t(x), _t(w), tm, tc)
        n_codes = int((np.asarray(jd["y8"]) != td["y8"].numpy()).sum())
        assert n_codes == 0
        _assert_dict_equal(jd, td)


def test_sar_adc_near_trial_levels():
    """The SAR search on a fabricated die over a dense sweep of inputs
    (steps of 1/64 LSB over the whole range and past both ends)."""
    jc, tc = _cfgs("prototype")
    jm, tm = _die(jc, 5)
    v = (np.arange(-70 * 64, 70 * 64) / 64.0).astype(np.float32)
    want = jax.jit(lambda a: Jc.sar_adc(a, jm.adc_cap_eps, jc))(
        jnp.asarray(v))
    np.testing.assert_array_equal(np.asarray(want),
                                  Tc.sar_adc(_t(v), tm.adc_cap_eps, tc).numpy())


def test_fabricate_draws_the_reference_sigmas():
    """The port's own draws: shapes, and per-cell spreads within 12 % of
    the reference's sigmas over 1,000 dies."""
    for name in ("prototype", "per_macro_averaged"):
        jc, tc = _cfgs(name)
        gen = torch.Generator().manual_seed(0)
        dies = [Tc.fabricate(gen, tc) for _ in range(1000)]
        ref = Jc.fabricate(jax.random.PRNGKey(0), jc)
        for field in ("eps_array", "adc_cap_eps", "vref_pol_eps"):
            assert tuple(getattr(dies[0], field).shape) == tuple(
                np.shape(getattr(ref, field)))
        sig = {"eps_array": torch.stack([d.eps_array for d in dies]).std(0),
               "adc_cap_eps": torch.stack([d.adc_cap_eps for d in dies]
                                          ).std(0)}
        refs = jax.jit(jax.vmap(lambda k: Jc.fabricate(k, jc)))(
            jax.random.split(jax.random.PRNGKey(1), 1000))
        for field, s in sig.items():
            r = np.std(np.asarray(getattr(refs, field)), 0)
            np.testing.assert_allclose(s.numpy(), r, rtol=0.12)
    assert Tc.ideal_macro(tc).eps_array.abs().sum() == 0


@pytest.mark.parametrize("fidelity", ["exact", "fast_broadcast", "bit_true",
                                      "fast"])
@pytest.mark.parametrize("name", ["prototype", "all_analog"])
def test_cim_matmul_int_fidelities(fidelity, name):
    """cim_matmul_int at every fidelity, raw and packed, on the ideal die
    and on a fabricated one (bit_true)."""
    jc, tc = _cfgs(name)
    rng = np.random.default_rng(3)
    M, K, N = 6, 70, 9
    x, w = _ints(rng, (M, K)), _ints(rng, (K, N))
    one = np.ones((1, N), np.float32)
    jpk = Je.pack_quantized_cim_weights(jnp.asarray(w), jnp.asarray(one), jc)
    tpk = Te.pack_quantized_cim_weights(_t(w), _t(one), tc)
    dies = [(Jc.ideal_macro(jc), Tc.ideal_macro(tc)), _die(jc, 9)]
    for jm, tm in (dies if fidelity == "bit_true" else dies[:1]):
        want = np.asarray(Jc.cim_matmul_int(
            jnp.asarray(x), jnp.asarray(w), jm, jc, None, fidelity,
            use_pallas=False))
        np.testing.assert_array_equal(
            want, np.asarray(Jc.cim_matmul_int(jnp.asarray(x), jpk, jm, jc,
                                               None, fidelity,
                                               use_pallas=False)))
        for wt in (_t(w), tpk):
            got = Tc.cim_matmul_int(_t(x), wt, tc, fidelity=fidelity,
                                    macro=tm)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(want, got.numpy())


def test_cim_matmul_float_bit_true_and_exact():
    jc, tc = _cfgs("prototype")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    w = rng.standard_normal((48, 7)).astype(np.float32)
    jm, tm = _die(jc, 3)
    tpk = Te.pack_cim_weights(_t(w), tc)
    for fid in ("bit_true", "exact"):
        want = np.asarray(jax.jit(lambda a, b: Jc.cim_matmul(
            a, b, jc, None, jm, fid, use_pallas=False))(jnp.asarray(x),
                                                         jnp.asarray(w)))
        for wt in (_t(w), tpk):
            np.testing.assert_array_equal(
                want, Tc.cim_matmul(_t(x), wt, tc, fidelity=fid,
                                    macro=tm).numpy())


def test_fidelity_arguments_checked():
    tc = Tc.DEFAULT_CONFIG
    x, w = torch.ones((2, 16), dtype=torch.int32), torch.ones(
        (16, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="MacroInstance"):
        Tc.cim_matmul_int(x, w, tc, fidelity="bit_true")
    with pytest.raises(ValueError, match="fidelity"):
        Tc.cim_matmul_int(x, w, tc, fidelity="noisy")
    # a noise key is a core.prng key: anything else is refused, and a key
    # gives the reference's noisy codes (tests/test_torch_die_noise.py)
    with pytest.raises(ValueError, match="key"):
        Tc.hybrid_mac_bit_true(x, x, Tc.ideal_macro(tc), tc,
                               noise_key=torch.zeros(3))
    with pytest.raises(ValueError, match="key"):
        Tc.sar_adc(torch.zeros(3), torch.zeros(7), tc,
                   noise_key=torch.zeros(3))
    v = np.linspace(-70, 70, 301, dtype=np.float32)
    jm, tm = _die(Jc.DEFAULT_CONFIG, 4)
    want = jax.jit(lambda a, k: Jc.sar_adc(a, jm.adc_cap_eps,
                                           Jc.DEFAULT_CONFIG, k))(
        jnp.asarray(v), jax.random.PRNGKey(9))
    got = Tc.sar_adc(_t(v), tm.adc_cap_eps, tc,
                     torch.tensor([0, 9], dtype=torch.int64))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("die", ["ideal", "fabricated"])
def test_complex_fallback_bit_true(die):
    """The four-GEMM complex fallback at 'bit_true', raw and packed."""
    jc, tc = _cfgs("prototype")
    rng = np.random.default_rng(5)
    M, K, N = 4, 40, 6
    xr, xi = _ints(rng, (M, K)), _ints(rng, (M, K))
    wr, wi = _ints(rng, (K, N)), _ints(rng, (K, N))
    jm, tm = ((Jc.ideal_macro(jc), Tc.ideal_macro(tc)) if die == "ideal"
              else _die(jc, 6))
    want = Jx.complex_cim_matmul_int(
        *(jnp.asarray(v) for v in (xr, xi, wr, wi)), jm, jc, None,
        "bit_true", use_pallas=False)
    one = torch.ones((1, N))
    pk = Te.PackedComplexCimWeights(
        Te.pack_quantized_cim_weights(_t(wr), one, tc),
        Te.pack_quantized_cim_weights(_t(wi), one, tc))
    for ws in ((_t(wr), _t(wi)), (pk, None)):
        got = Tx.complex_cim_matmul_int(_t(xr), _t(xi), *ws, tc,
                                        fidelity="bit_true", macro=tm)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_baselines():
    jc, tc = _cfgs("prototype")
    rng = np.random.default_rng(8)
    x, w = _ints(rng, (200, 16)), _ints(rng, (200, 16))
    xi, wi = _ints(rng, (200, 16)), _ints(rng, (200, 16))
    np.testing.assert_array_equal(
        np.asarray(Jb.all_digital_mac(jnp.asarray(x), jnp.asarray(w))),
        Tb.all_digital_mac(_t(x), _t(w)).numpy())
    ja, ta = Jb.all_analog_config(jc), Tb.all_analog_config(tc)
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
    jma, tma = _die(ja, 10)
    _assert_dict_equal(
        Jb.all_analog_mac(jnp.asarray(x), jnp.asarray(w), jma, jc),
        Tb.all_analog_mac(_t(x), _t(w), tma, tc))
    (jm_a, tm_a), (jm_b, tm_b) = _die(jc, 11), _die(jc, 12)
    J = [jnp.asarray(v) for v in (x, xi, w, wi)]
    T = [_t(v) for v in (x, xi, w, wi)]
    for jf, tf in ((Jb.duplicated_cmac(*J, jm_a, jm_b, jc),
                    Tb.duplicated_cmac(*T, tm_a, tm_b, tc)),
                   (Jb.sequential_cmac(*J, jm_a, jc),
                    Tb.sequential_cmac(*T, tm_a, tc))):
        for a, b in zip(jf, tf):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_costmodel_values(name):
    jc, tc = _cfgs(name)
    assert Jcost.energy_per_conversion_pj(jc) == \
        Tcost.energy_per_conversion_pj(tc)
    assert Jcost.tops_per_watt(jc) == Tcost.tops_per_watt(tc)
    assert Jcost.macro_area_breakdown(jc) == Tcost.macro_area_breakdown(tc)
    assert Jcost.figS1_comparison(jc) == Tcost.figS1_comparison(tc)
    for f in ("fast", "fast_broadcast", "bit_true", "exact"):
        assert Jcost.macro_cost(jc, f).as_dict() == \
            Tcost.macro_cost(tc, f).as_dict()
    assert Jcost.adc_dnl_lsb_rms(jc) == Tcost.adc_dnl_lsb_rms(tc)
    assert Jcost.density_mb_per_mm2() == Tcost.density_mb_per_mm2()
    with pytest.raises(ValueError):
        Tcost.macro_cost(tc, "float")
