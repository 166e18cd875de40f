"""Port parity: repro_torch.core.ccim against repro.core.ccim.

Inputs are made with numpy from a seed and handed to both sides.  Every
comparison here is on integers, or on float32 values computed by the
same IEEE operations, so the tolerance is zero: ``==``.  The design
points are the 42 that cimlint audits (n_dcim 0-6 x ADC 7/8/9 b x
acc_len 16/32) plus acc_len 8 and 64, which the prepacked kernels also
admit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ccim as J
from repro_torch.core import ccim as T

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

DESIGN_POINTS = [(nd, adc, acc) for nd in range(7) for adc in (7, 8, 9)
                 for acc in (8, 16, 32, 64)]


def _cfgs(nd, adc, acc):
    return (J.CCIMConfig(n_dcim_products=nd, adc_bits=adc, acc_len=acc),
            T.CCIMConfig(n_dcim_products=nd, adc_bits=adc, acc_len=acc))


def test_config_fields_and_properties_match():
    assert ([f.name for f in dataclasses.fields(T.CCIMConfig)]
            == [f.name for f in dataclasses.fields(J.CCIMConfig)])
    assert dataclasses.asdict(T.DEFAULT_CONFIG) == dataclasses.asdict(
        J.DEFAULT_CONFIG)
    for nd, adc, acc in DESIGN_POINTS:
        jc, tc = _cfgs(nd, adc, acc)
        for prop in ("max_mag", "dcim_products", "dcim_lsb",
                     "adc_half_range", "dcim_max"):
            assert getattr(tc, prop) == getattr(jc, prop), (prop, nd, adc, acc)
        assert T._dcim_by_j(tc) == J._dcim_by_j(jc)
        assert list(T._dcim_by_j(tc)) == list(J._dcim_by_j(jc))  # order


@pytest.mark.parametrize("shape,axis", [((7, 33), -1), ((33, 9), 0),
                                        ((5, 4, 16), -1), ((12,), None)])
def test_smf_scale_and_quantize_bit_identical(shape, axis):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30)).astype(np.float32)
    keep = axis is not None
    sj = J.smf_scale(jnp.asarray(x), axis=axis, keepdims=keep)
    st = T.smf_scale(torch.from_numpy(x), dim=axis, keepdim=keep)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(
        np.asarray(J.quantize_smf(jnp.asarray(x), sj)),
        T.quantize_smf(torch.from_numpy(x), st).numpy())


def test_quantize_rounds_half_to_even():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 200.0, -300.0],
                 np.float32)
    one = np.float32(1.0)
    np.testing.assert_array_equal(
        np.asarray(J.quantize_smf(jnp.asarray(x), one)),
        T.quantize_smf(torch.from_numpy(x), torch.tensor(one)).numpy())


@pytest.mark.parametrize("nd,adc,acc", DESIGN_POINTS)
def test_fast_gemm_and_planes_bit_identical(nd, adc, acc):
    jc, tc = _cfgs(nd, adc, acc)
    rng = np.random.default_rng(nd * 100 + adc * 10 + acc)
    M, C, N = 5, 4, 24
    xq = rng.integers(-127, 128, (M, C, acc)).astype(np.int32)
    wq = rng.integers(-127, 128, (C, acc, N)).astype(np.int32)
    wq[0, 0, :] = 0                                   # sign(0) = +1 edge
    pj = J.fold_dcim_planes(jnp.asarray(wq), jc)
    pt = T.fold_dcim_planes(torch.from_numpy(wq), tc)
    assert len(pj) == len(pt)
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    yj = J.hybrid_mac_fast_gemm(jnp.asarray(xq), jnp.asarray(wq), None, jc)
    yt = T.hybrid_mac_fast_gemm(torch.from_numpy(xq), torch.from_numpy(wq),
                                None, tc)
    assert yt.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


@pytest.mark.parametrize("nd,adc,acc", [(3, 7, 16), (0, 9, 8), (6, 8, 64)])
def test_cim_matmul_int_raw_weights_bit_identical(nd, adc, acc):
    jc, tc = _cfgs(nd, adc, acc)
    rng = np.random.default_rng(acc)
    x = rng.integers(-127, 128, (6, 100)).astype(np.int32)
    w = rng.integers(-127, 128, (100, 20)).astype(np.int32)
    yj = J.cim_matmul_int(jnp.asarray(x), jnp.asarray(w), None, jc,
                          use_pallas=False)
    yt = T.cim_matmul_int(torch.from_numpy(x), torch.from_numpy(w), tc)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


@pytest.mark.parametrize("nd,adc,acc,per_channel", [
    (3, 7, 16, True), (3, 7, 16, False), (2, 8, 32, True)])
def test_cim_matmul_float_raw_weights_bit_identical(nd, adc, acc,
                                                    per_channel):
    """Float cim_matmul on raw weights: the prototype split runs the
    unpacked GEMM, other design points pack for the call; both equal the
    reference, and the port's pack of the same weights."""
    jc, tc = _cfgs(nd, adc, acc)
    rng = np.random.default_rng(nd + adc + acc)
    x = rng.standard_normal((5, 70)).astype(np.float32)
    w = rng.standard_normal((70, 9)).astype(np.float32)
    yj = J.cim_matmul(jnp.asarray(x), jnp.asarray(w), jc,
                      per_channel=per_channel, use_pallas=False)
    yt = T.cim_matmul(torch.from_numpy(x), torch.from_numpy(w), tc,
                      per_channel=per_channel)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    if per_channel:
        from repro_torch.core.engine import pack_cim_weights
        assert torch.equal(yt, T.cim_matmul(
            torch.from_numpy(x), pack_cim_weights(torch.from_numpy(w), tc),
            tc))


def test_chunk_blocking_is_invisible():
    rng = np.random.default_rng(3)
    xq = torch.from_numpy(rng.integers(-127, 128, (9, 11, 16)).astype(np.int32))
    wq = torch.from_numpy(rng.integers(-127, 128, (11, 16, 7)).astype(np.int32))
    wf, w_pl = T.fast_gemm_weight_ops(wq)
    ref = T.fast_gemm_int(xq, wf, w_pl, (6, 5), 2048, 64)
    for cb in (1, 3, 11):
        assert torch.equal(ref, T.fast_gemm_int(xq, wf, w_pl, (6, 5), 2048,
                                                64, chunk_block=cb))


def test_noise_key_is_refused():
    """The noisy GEMMs take a ``core.prng`` key and refuse anything else;
    with a key, raw weights give the reference's noisy ints at 'fast' and
    'fast_broadcast' (tests/test_torch_die_noise.py holds every fidelity,
    packed and complex), and 'exact' ignores it."""
    import jax
    xq = torch.zeros((1, 1, 16), dtype=torch.int32)
    wq = torch.zeros((1, 16, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="key"):
        T.hybrid_mac_fast_gemm(xq, wq, noise_key=torch.zeros(3))
    with pytest.raises(ValueError, match="key"):
        T.cim_matmul_int(xq[0], wq[0], noise_key=torch.zeros(3))
    rng = np.random.default_rng(21)
    x = rng.integers(-127, 128, (3, 40)).astype(np.int32)
    w = rng.integers(-127, 128, (40, 5)).astype(np.int32)
    jk = jax.random.PRNGKey(7)
    key = torch.tensor([0, 7])
    for fid in ("fast_broadcast", "fast"):
        want = jax.jit(lambda a, b, k: J.cim_matmul_int(
            a, b, None, J.DEFAULT_CONFIG, k, fid, use_pallas=False))(
            jnp.asarray(x), jnp.asarray(w), jk)
        got = T.cim_matmul_int(torch.from_numpy(x), torch.from_numpy(w),
                               noise_key=key, fidelity=fid)
        assert np.array_equal(np.asarray(want), got.numpy()), fid
    assert torch.equal(T.cim_matmul_int(xq[0], wq[0], noise_key=key,
                                        fidelity="exact"),
                       torch.zeros((1, 2), dtype=torch.int32))
