"""Port parity: the macro's draws off the fast packed path -- keyed dies,
the SAR's comparator noise, noisy bit-true and broadcast GEMMs, the raw
weight noisy fast GEMM, noisy complex GEMMs (raw and packed) and the
noisy baselines -- against the reference on the same keys and numpy
inputs.

Every die field, every integer and every ``a_real`` is compared with
``==``.  The draws are ``core/prng.py``'s, equal to ``jax.random``'s.
The comparator sees sample + 0.45 * normal: the reference's compiled
code (``jax.jit``, as its Fig. 6 and kernel bench run it) folds 0.45
into the normal's sqrt(2) and fuses the add, op by op it rounds the
product first.  The port follows the compiled form
(``prng.scaled_normal_fma``): over the uniform samples below no code
differs from either form (``SAR_EAGER_RESIDUE`` = 0 of 2^16), and on
samples placed within an ulp of the first trial level, where the two
forms decide differently, the port's codes equal the compiled ones
(``test_sar_follows_the_compiled_form_at_trial_levels``).
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
from repro.core import engine as Je
from repro_torch.core import baselines as Tb
from repro_torch.core import ccim as Tc
from repro_torch.core import complex_mac as Tx
from repro_torch.core import engine as Te
from repro_torch.core import prng as P

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

# codes of noisy sar_adc over 2^16 uniform samples that differ between
# the port (the compiled form) and the reference run op by op
SAR_EAGER_RESIDUE = 0

DIE_CFGS = [dict(mismatch_granularity=g, use_split_dac=s,
                 adc_mismatch_model=a)
            for g in ("per_unit", "per_macro") for s in (True, False)
            for a in ("conservative", "averaged")]


def _key(seed: int, data: int = 0):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


def _ints(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _dies(seed: int, cfg_kw=None):
    """The reference's die of PRNGKey(seed) and the port's of the same
    key."""
    cfg_kw = cfg_kw or {}
    return (Jc.fabricate(jax.random.PRNGKey(seed), Jc.CCIMConfig(**cfg_kw)),
            Tc.fabricate(P.PRNGKey(seed), Tc.CCIMConfig(**cfg_kw)))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 32 - 1])
@pytest.mark.parametrize("cfg_kw", DIE_CFGS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_keyed_fabricate_equals_reference(seed, cfg_kw):
    jm, tm = _dies(seed, cfg_kw)
    for field in ("eps_array", "adc_cap_eps", "vref_pol_eps"):
        want = np.asarray(getattr(jm, field))
        got = getattr(tm, field)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(want, got.numpy(), err_msg=field)
    # the generator form stays: torch's own draws, the same sigmas' shapes
    gm = Tc.fabricate(torch.Generator().manual_seed(seed),
                      Tc.CCIMConfig(**cfg_kw))
    assert gm.eps_array.shape == tm.eps_array.shape
    assert not torch.equal(gm.eps_array, tm.eps_array)


def _sar_inputs(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-70, 70, n).astype(np.float32)
    jm, tm = _dies(seed)
    return v, jm, tm


def test_noisy_sar_equals_reference_jit_and_op_by_op():
    v, jm, tm = _sar_inputs(1 << 16)
    jk, tk = _key(11)
    cfg = Jc.DEFAULT_CONFIG
    jit = np.asarray(jax.jit(lambda a, e, k: Jc.sar_adc(a, e, cfg, k))(
        jnp.asarray(v), jm.adc_cap_eps, jk))
    eager = np.asarray(Jc.sar_adc(jnp.asarray(v), jm.adc_cap_eps, cfg, jk))
    got = Tc.sar_adc(_t(v), tm.adc_cap_eps, Tc.DEFAULT_CONFIG, tk).numpy()
    assert int((jit != got).sum()) == 0
    assert int((eager != got).sum()) == SAR_EAGER_RESIDUE
    clean = Tc.sar_adc(_t(v), tm.adc_cap_eps).numpy()
    assert (clean != got).mean() > 0.1          # the noise moved codes
    # a block of the samples draws its own flat indices of the batch
    blk = Tc.sar_adc(_t(v[1000:3000]), tm.adc_cap_eps, Tc.DEFAULT_CONFIG,
                     tk, draw_offset=1000).numpy()
    np.testing.assert_array_equal(blk, got[1000:3000])
    # no comparator noise: a key changes nothing
    quiet = Tc.CCIMConfig(comparator_noise_lsb=0.0)
    np.testing.assert_array_equal(
        Tc.sar_adc(_t(v), tm.adc_cap_eps, quiet, tk).numpy(), clean)


def test_sar_follows_the_compiled_form_at_trial_levels():
    """Samples placed where sample + 0.45 n lands within a few ulps of
    the MSB's trial level, chosen so that the fused and the rounded sum
    fall on opposite sides: the port's codes equal the reference's under
    ``jax.jit`` on every one, and the op-by-op reference's differ."""
    n = 1 << 14
    cfg = Jc.DEFAULT_CONFIG
    jm, tm = _dies(5)
    jk, tk = _key(12)
    keys = P.split(tk, cfg.adc_bits)
    idx = torch.arange(n, dtype=torch.int64)
    noise = P.normal_from_bits(P.bits_at(keys[6], idx)).numpy()
    trial = np.float32(64.0) * (np.float32(1.0)
                                + np.asarray(jm.adc_cap_eps)[6])
    c = np.float32(cfg.comparator_noise_lsb)
    bits = P.bits_at(keys[6], idx)
    x0 = (trial - c * noise).astype(np.float32)
    x = np.full(n, np.float32(100.0), np.float32)
    placed = np.zeros(n, bool)
    for k in range(-4, 5):
        xk = (x0 + np.float32(k) * np.spacing(x0)).astype(np.float32)
        fused = P.scaled_normal_fma(bits, cfg.comparator_noise_lsb,
                                    torch.from_numpy(xk)).numpy()
        rounded = xk + (c * noise).astype(np.float32)
        new = (~placed & (64.5 <= x0) & (x0 <= 127.5)
               & ((fused >= trial) != (rounded >= trial)))
        x[new], placed[new] = xk[new], True
    assert placed.sum() > 20
    v = (x.astype(np.float64) - 64.5).astype(np.float32)   # exact
    assert np.array_equal((v + np.float32(64)) + np.float32(0.5), x)
    jit = np.asarray(jax.jit(lambda a, e, k: Jc.sar_adc(a, e, cfg, k))(
        jnp.asarray(v), jm.adc_cap_eps, jk))
    eager = np.asarray(Jc.sar_adc(jnp.asarray(v), jm.adc_cap_eps, cfg, jk))
    got = Tc.sar_adc(_t(v), tm.adc_cap_eps, Tc.DEFAULT_CONFIG, tk).numpy()
    assert int((jit != got).sum()) == 0
    assert int((eager != got)[placed].sum()) > 0.9 * placed.sum()


@pytest.mark.parametrize("cfg_kw", [{}, dict(n_dcim_products=0, adc_bits=8),
                                    dict(mismatch_granularity="per_macro")])
def test_noisy_bit_true_mac_equals_reference(cfg_kw):
    rng = np.random.default_rng(4)
    jc, tc = Jc.CCIMConfig(**cfg_kw), Tc.CCIMConfig(**cfg_kw)
    L = jc.acc_len
    x, w = _ints(rng, (6, 1, 3, L)), _ints(rng, (1, 5, 3, L))
    jm, tm = _dies(7, cfg_kw)
    jk, tk = _key(13)
    want = jax.jit(lambda a, b, k: Jc.hybrid_mac_bit_true(a, b, jm, jc, k))(
        jnp.asarray(x), jnp.asarray(w), jk)
    got = Tc.hybrid_mac_bit_true(_t(x), _t(w), tm, tc, tk)
    for key in ("y8", "dcim", "adc_code", "a_real", "a_ideal", "exact"):
        np.testing.assert_array_equal(np.asarray(want[key]),
                                      got[key].numpy(), err_msg=key)
    clean = Tc.hybrid_mac_bit_true(_t(x), _t(w), tm, tc)
    assert not torch.equal(clean["adc_code"], got["adc_code"])


@pytest.mark.parametrize("fidelity", ["bit_true", "fast_broadcast", "fast"])
@pytest.mark.parametrize("packed", [False, True])
def test_noisy_cim_matmul_int_equals_reference(monkeypatch, fidelity,
                                               packed):
    """Raw and packed weights; the broadcast fidelities evaluate blocks of
    one or two rows (``_BROADCAST_ELEMS`` made small), and each block's
    draws are its slice of the reference's (M, N, C) draw."""
    monkeypatch.setattr(Tc, "_BROADCAST_ELEMS", 2 * 7 * 3 * 16)
    rng = np.random.default_rng(8)
    x, w = _ints(rng, (5, 40)), _ints(rng, (40, 7))
    jm, tm = _dies(9)
    jk, tk = _key(14)
    cfg = Jc.DEFAULT_CONFIG
    want = np.asarray(jax.jit(lambda a, b, k: Jc.cim_matmul_int(
        a, b, jm, cfg, k, fidelity, use_pallas=False))(
        jnp.asarray(x), jnp.asarray(w), jk))
    wt = _t(w)
    if packed:
        wt = Te.pack_quantized_cim_weights(wt, torch.ones((1, 7)),
                                           Tc.DEFAULT_CONFIG)
    got = Tc.cim_matmul_int(_t(x), wt, Tc.DEFAULT_CONFIG, tk, fidelity,
                            macro=tm)
    np.testing.assert_array_equal(want, got.numpy())
    clean = Tc.cim_matmul_int(_t(x), wt, Tc.DEFAULT_CONFIG, None, fidelity,
                              macro=tm)
    assert not torch.equal(got, clean)
    # 'exact' ignores a key, as the reference's does
    assert torch.equal(
        Tc.cim_matmul_int(_t(x), wt, Tc.DEFAULT_CONFIG, tk, "exact"),
        Tc.cim_matmul_int(_t(x), wt, Tc.DEFAULT_CONFIG, None, "exact"))


@pytest.mark.parametrize("fidelity", ["fast", "bit_true"])
def test_noisy_complex_equals_reference_raw_and_packed(fidelity):
    rng = np.random.default_rng(10)
    M, K, N = 4, 40, 6
    xr, xi = _ints(rng, (M, K)), _ints(rng, (M, K))
    wr, wi = _ints(rng, (K, N)), _ints(rng, (K, N))
    jm, tm = _dies(11)
    jk, tk = _key(15)
    cfg = Jc.DEFAULT_CONFIG
    want = jax.jit(lambda a, b, c, d, k: Jx.complex_cim_matmul_int(
        a, b, c, d, jm, cfg, k, fidelity, use_pallas=False))(
        *(jnp.asarray(v) for v in (xr, xi, wr, wi)), jk)
    raw = Tx.complex_cim_matmul_int(_t(xr), _t(xi), _t(wr), _t(wi),
                                    Tc.DEFAULT_CONFIG, tk, fidelity,
                                    macro=tm)
    one = torch.ones((1, N))
    pk = Te.PackedComplexCimWeights(
        Te.pack_quantized_cim_weights(_t(wr), one, Tc.DEFAULT_CONFIG),
        Te.pack_quantized_cim_weights(_t(wi), one, Tc.DEFAULT_CONFIG))
    packed = Tx.complex_cim_matmul_int(_t(xr), _t(xi), pk, None,
                                       Tc.DEFAULT_CONFIG, tk, fidelity,
                                       macro=tm)
    for w_, r_, p_ in zip(want, raw, packed):
        np.testing.assert_array_equal(np.asarray(w_), r_.numpy())
        assert torch.equal(r_, p_)
    clean = Tx.complex_cim_matmul_int(_t(xr), _t(xi), _t(wr), _t(wi),
                                      Tc.DEFAULT_CONFIG, None, fidelity,
                                      macro=tm)
    assert not torch.equal(clean[0], raw[0])


def test_noisy_complex_float_equals_reference_packed():
    """The float complex GEMM on a pack against the reference's on raw
    weights (the DoA spectrum's route), complex64 compared with ``==``."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((6, 8)) + 1j * rng.standard_normal((6, 8))
         ).astype(np.complex64)
    w = (rng.standard_normal((8, 30)) + 1j * rng.standard_normal((8, 30))
         ).astype(np.complex64)
    jk, tk = _key(16)
    want = Jx.complex_cim_matmul(jnp.asarray(x), jnp.asarray(w),
                                 Jc.DEFAULT_CONFIG, noise_key=jk)
    tw = torch.from_numpy(w)
    pk = Te.pack_complex_cim_weights(tw.real.contiguous(),
                                     tw.imag.contiguous())
    for wt in (tw, pk):
        got = Tx.complex_cim_matmul(torch.from_numpy(x), wt,
                                    Tc.DEFAULT_CONFIG, tk)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_noisy_baselines_equal_reference():
    rng = np.random.default_rng(13)
    L = Jc.DEFAULT_CONFIG.acc_len
    xr, xi, wr, wi = (_ints(rng, (9, L)) for _ in range(4))
    ja, ta = _dies(20)
    jb_, tb_ = _dies(21)
    jaa, taa = _dies(22, dataclasses.asdict(
        Jb.all_analog_config(Jc.DEFAULT_CONFIG)))
    jk, tk = _key(17)
    want = Jb.all_analog_mac(jnp.asarray(xr), jnp.asarray(wr), jaa,
                             noise_key=jk)
    got = Tb.all_analog_mac(_t(xr), _t(wr), taa, noise_key=tk)
    for key in ("y8", "adc_code", "a_real"):
        np.testing.assert_array_equal(np.asarray(want[key]),
                                      got[key].numpy(), err_msg=key)
    j = [jnp.asarray(v) for v in (xr, xi, wr, wi)]
    t = [_t(v) for v in (xr, xi, wr, wi)]
    pairs = [(Jb.duplicated_cmac(*j, ja, jb_, noise_key=jk),
              Tb.duplicated_cmac(*t, ta, tb_, noise_key=tk)),
             (Jb.sequential_cmac(*j, ja, noise_key=jk),
              Tb.sequential_cmac(*t, ta, noise_key=tk))]
    for want, got in pairs:
        for w_, g_ in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w_), g_.numpy())
    clean = Tb.sequential_cmac(*t, ta)
    assert not torch.equal(clean[0], pairs[1][1][0])
