"""Port parity: repro_torch.core.engine (packing and packed execution)
against repro.core.engine.

Pack contents (scale, sign, mag, the folded planes and the float32
chunked operands that the reference stores as gemm_w/gemm_planes) are
compared with ``==`` on the logical K x N region: packing is integer
arithmetic plus one float32 scale computed by the same IEEE operations.
``packed_cim_matmul`` outputs are float32 products of identical ints and
scales in the same order, so they too are compared with ``==``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import ccim as Jc
from repro.core import engine as J
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.convert import packed_from_jax, params_from_jax
from repro_torch.core import ccim as Tc
from repro_torch.core import engine as T
from repro_torch.models import lm as tlm

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

PACK_POINTS = [(nd, acc) for nd in range(7) for acc in (8, 16, 32, 64)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_pack_equal(jp, tp):
    """Reference pack (numpy leaves) == port pack, field by field."""
    np.testing.assert_array_equal(np.asarray(jp.scale), tp.scale.numpy())
    np.testing.assert_array_equal(np.asarray(jp.sign), tp.sign.numpy())
    np.testing.assert_array_equal(np.asarray(jp.mag), tp.mag.numpy())
    mapped = packed_from_jax(_np(jp), "cpu")
    assert torch.equal(mapped.kernel_w, tp.kernel_w)
    assert torch.equal(mapped.kernel_planes, tp.kernel_planes)
    assert (tp.k_dim, tp.n_dim) == (jp.k_dim, jp.n_dim)


@pytest.mark.parametrize("nd,acc", PACK_POINTS)
def test_pack_and_packed_matmul_bit_identical(nd, acc):
    """Every design point: n_dcim 0-6 x acc_len 8/16/32/64 packs, each
    served at ADC 7/8/9 b (the pack does not depend on the ADC width, so
    one pack per split serves the three, relabelled with each config)."""
    jc = Jc.CCIMConfig(n_dcim_products=nd, acc_len=acc)
    tc = Tc.CCIMConfig(n_dcim_products=nd, acc_len=acc)
    rng = np.random.default_rng(nd * 100 + acc)
    x = rng.standard_normal((5, 100)).astype(np.float32)
    w = rng.standard_normal((100, 24)).astype(np.float32)
    jp = J.pack_cim_weights(jnp.asarray(w), jc)
    tp = T.pack_cim_weights(torch.from_numpy(w), tc)
    _assert_pack_equal(jp, tp)
    gw, gp = tp.gemm_operands()
    np.testing.assert_array_equal(np.asarray(jp.gemm_w), gw.numpy())
    np.testing.assert_array_equal(np.asarray(jp.gemm_planes), gp.numpy())
    for adc in (7, 8, 9):
        jca = dataclasses.replace(jc, adc_bits=adc)
        tca = dataclasses.replace(tc, adc_bits=adc)
        yj = J.packed_cim_matmul(jnp.asarray(x),
                                 dataclasses.replace(jp, cfg=jca), jca,
                                 use_pallas=False)
        yt = T.packed_cim_matmul(torch.from_numpy(x),
                                 dataclasses.replace(tp, cfg=tca), tca)
        np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


@pytest.mark.parametrize("adc,acc", [(5, 16), (7, 8), (9, 64)])
def test_analog_subset_serving_of_hybrid_pack(adc, acc):
    hj = Jc.CCIMConfig(n_dcim_products=3, acc_len=acc)
    ht = Tc.CCIMConfig(n_dcim_products=3, acc_len=acc)
    sj = Jc.CCIMConfig(n_dcim_products=0, adc_bits=adc, acc_len=acc)
    st = Tc.CCIMConfig(n_dcim_products=0, adc_bits=adc, acc_len=acc)
    assert T.pack_compatible(ht, st) and J.pack_compatible(hj, sj)
    rng = np.random.default_rng(adc + acc)
    x = rng.standard_normal((3, 72)).astype(np.float32)
    w = rng.standard_normal((72, 16)).astype(np.float32)
    yj = J.packed_cim_matmul(jnp.asarray(x), J.pack_cim_weights(
        jnp.asarray(w), hj), sj, use_pallas=False)
    yt = T.packed_cim_matmul(torch.from_numpy(x), T.pack_cim_weights(
        torch.from_numpy(w), ht), st)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


def test_pack_config_mismatch_rejected():
    p = T.pack_cim_weights(torch.randn(32, 8), Tc.CCIMConfig(acc_len=16))
    with pytest.raises(ValueError, match="different CCIMConfig"):
        T.packed_cim_matmul(torch.randn(2, 32), p, Tc.CCIMConfig(acc_len=32))
    # 'bit_true' is served now, and needs its die
    with pytest.raises(ValueError, match="MacroInstance"):
        T.packed_cim_matmul(torch.randn(2, 32), p, Tc.DEFAULT_CONFIG,
                            fidelity="bit_true")


@pytest.mark.parametrize("fuse", [True, False])
def test_pack_cim_params_matches_jax_tree(fuse):
    """Stacked (per-layer) packs of the smoke model, fused and unfused,
    equal the reference's pack leaf for leaf."""
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True,
                               cim_fuse=fuse)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=True,
                               cim_fuse=fuse)
    jparams, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jparams),
        tcfg, "cpu")
    jpk = jlm.pack_cim_params(jparams, jcfg)
    tpk = tlm.pack_cim_params(tparams, tcfg, "cpu")
    for block in ("attn", "mlp"):
        jb, tb = jpk["layers"][block], tpk["layers"][block]
        assert sorted(jb) == sorted(tb)
        for key in jb:
            a, b = jb[key], tb[key]
            if isinstance(a, J.FusedPackedCimWeights):
                assert isinstance(b, T.FusedPackedCimWeights)
                assert (a.seg_names, a.seg_dims) == (b.seg_names, b.seg_dims)
                a, b = a.packed, b.packed
            mapped = packed_from_jax(_np(a), "cpu")
            for f in ("scale", "kernel_w", "kernel_planes"):
                assert torch.equal(getattr(mapped, f), getattr(b, f)), (key, f)
            for i in range(tcfg.n_layers):       # per-layer views
                li = b.layer(i)
                np.testing.assert_array_equal(np.asarray(a.sign[i]),
                                              li.sign.numpy())


def test_engine_refuses_unpacked_weights():
    """Raw weights are served now, quantized per call, and equal their
    pack bit for bit (tests/test_torch_unpacked.py holds both to the
    reference); a pack keeps the leading axes of x."""
    eng = T.CimEngine()
    x, w = torch.randn(2, 16), torch.randn(16, 4)
    assert torch.equal(eng.matmul(x, w), eng.matmul(x, eng.pack(w)))
    p = eng.pack(torch.randn(16, 4))
    assert eng.matmul(torch.randn(3, 2, 16), p).shape == (3, 2, 4)
