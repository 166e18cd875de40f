"""Port parity: the complex-MAC lane (core/complex_mac, the complex pack,
kernels/ccim_complex) against the reference.

Inputs are made with numpy from a seed and handed to both sides.  The
reference runs its fused Pallas kernels in interpret mode and its
default CPU path (four real macro GEMMs); the port runs the plain
versions of its CUDA kernels (CPU tensors).  Integer results and pack
contents are compared with ``==``; the float outputs are float32
products of identical ints and scales in the same order, so they too
are compared with ``==``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ccim as Jc
from repro.core import complex_mac as Jm
from repro.core import engine as Je
from repro.kernels import ccim_complex as Jk
from repro_torch.convert import packed_complex_from_jax
from repro_torch.core import ccim as Tc
from repro_torch.core import complex_mac as Tm
from repro_torch.core import engine as Te
from repro_torch.kernels.ccim_complex import kernel as K
from repro_torch.kernels.ccim_complex import ops as Tk
from repro_torch.kernels.ccim_complex.ref import ccim_complex_matmul_ref
from repro_torch.kernels.ccim_matmul import kernel as RK

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

# (M, K, N): ragged K, M and N as in tests/test_complex_kernel.py, M on
# both sides of the skinny/general split (the reference takes its skinny
# kernel at K 80 and its general one at K 37 and M 40)
SHAPES = [(5, 37, 11), (16, 80, 32), (40, 64, 9)]


def _ints(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int32)


def _operands(m, k, n):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    return (_ints(rng, m, k), _ints(rng, m, k), _ints(rng, k, n),
            _ints(rng, k, n))


def _complex(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _eq(jax_pair, torch_pair):
    for a, b in zip(jax_pair, torch_pair):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("k,n,nd", [(37, 11, 3), (64, 9, 3), (48, 20, 2)])
def test_pack_complex_bit_identical(k, n, nd):
    rng = np.random.default_rng(k + n + nd)
    wr = rng.standard_normal((k, n)).astype(np.float32)
    wi = 0.3 * rng.standard_normal((k, n)).astype(np.float32)
    jc = Jc.CCIMConfig(n_dcim_products=nd)
    tc = Tc.CCIMConfig(n_dcim_products=nd)
    jp = Je.pack_complex_cim_weights(jnp.asarray(wr), jnp.asarray(wi), jc)
    tp = Te.pack_complex_cim_weights(torch.from_numpy(wr),
                                     torch.from_numpy(wi), tc)
    ep = Te.CimEngine(cfg=tc).pack_complex(torch.from_numpy(wr),
                                           torch.from_numpy(wi))
    assert torch.equal(ep.im.kernel_planes, tp.im.kernel_planes)
    mapped = packed_complex_from_jax(_np(jp), "cpu")
    for jh, th, mh in ((jp.re, tp.re, mapped.re), (jp.im, tp.im, mapped.im)):
        np.testing.assert_array_equal(np.asarray(jh.scale), th.scale.numpy())
        np.testing.assert_array_equal(np.asarray(jh.sign), th.sign.numpy())
        np.testing.assert_array_equal(np.asarray(jh.mag), th.mag.numpy())
        assert torch.equal(mh.kernel_w, th.kernel_w)
        assert torch.equal(mh.kernel_planes, th.kernel_planes)
        assert torch.equal(mh.scale, th.scale)
    assert torch.equal(tp.re.scale, tp.im.scale)          # one shared scale


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_complex_int_raw_and_packed_bit_identical(m, k, n):
    """Raw operands against the reference's fused unpacked kernel
    (interpret mode) and its default path; a reference pack carried
    across against its prepacked fused kernels (skinny at M <= 32,
    general above) -- all equal the port's plain versions."""
    xr, xi, wr, wi = _operands(m, k, n)
    j = lambda v: jnp.asarray(v)
    t = torch.from_numpy
    port_raw = Tm.complex_cim_matmul_int(t(xr), t(xi), t(wr), t(wi))
    _eq(Jk.ccim_complex_matmul_int(j(xr), j(xi), j(wr), j(wi),
                                   use_pallas=True, interpret=True), port_raw)
    _eq(Jm.complex_cim_matmul_int(j(xr), j(xi), j(wr), j(wi)), port_raw)

    one = np.ones((1, n), np.float32)
    jpr = Je.pack_quantized_cim_weights(j(wr), j(one))
    jpi = Je.pack_quantized_cim_weights(j(wi), j(one))
    jpack = Je.PackedComplexCimWeights(re=jpr, im=jpi)
    tpack = packed_complex_from_jax(_np(jpack), "cpu")
    port_packed = Tm.complex_cim_matmul_int(t(xr), t(xi), tpack)
    _eq(port_raw, port_packed)
    _eq(Jk.ccim_complex_matmul_int_prepacked(
        j(xr), j(xi), jpr.pallas_w, jpi.pallas_w, jpr.pallas_planes[0],
        jpr.pallas_planes[1], jpi.pallas_planes[0], jpi.pallas_planes[1],
        k_dim=k, n_dim=n, use_pallas=True, interpret=True), port_packed)
    _eq(Jm.complex_cim_matmul_int(j(xr), j(xi), jpack), port_packed)


@pytest.mark.parametrize("m,k,n", [(5, 37, 11), (40, 64, 9)])
def test_int_oracle_and_plain_versions(m, k, n):
    """ref.py (four integer-oracle calls) == the reference's oracle ==
    both plain versions, on K-padded operands."""
    xr, xi, wr, wi = _operands(m, k, n)
    kp = -(-k // 16) * 16
    padx = lambda v: np.pad(v, ((0, 0), (0, kp - k)))
    padw = lambda v: np.pad(v, ((0, kp - k), (0, 0)))
    ops = [padx(xr), padx(xi), padw(wr), padw(wi)]
    ref = ccim_complex_matmul_ref(*map(torch.from_numpy, ops))
    _eq(Jk.ccim_complex_matmul_ref(*map(jnp.asarray, ops)), ref)
    i8 = [torch.from_numpy(v).to(torch.int8) for v in ops]
    _eq([r.numpy() for r in ref], K.ccim_complex_unpacked_plain(*i8))
    p = Te.PackedComplexCimWeights(
        *(Te.pack_quantized_cim_weights(torch.from_numpy(w),
                                        torch.ones((1, n))) for w in (wr, wi)))
    _eq([r.numpy() for r in ref], K.ccim_complex_prepacked_plain(
        i8[0], i8[1], p.re.kernel_w, p.re.kernel_planes, p.im.kernel_w,
        p.im.kernel_planes))


@pytest.mark.parametrize("m,k,n", [(36, 64, 12)])
def test_complex_float_bit_identical(m, k, n):
    """complex_cim_matmul on raw weights and on a pack (each side's own),
    and the kernel-level float wrapper ccim_complex_matmul (whose jitted
    reference scales by a reciprocal multiply: M 36 shows it)."""
    rng = np.random.default_rng(m + k + n)
    x, w = _complex(rng, m, k), 0.5 * _complex(rng, k, n)
    yj = np.asarray(Jm.complex_cim_matmul(jnp.asarray(x), jnp.asarray(w)))
    yt = Tm.complex_cim_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert yt.dtype == torch.complex64
    np.testing.assert_array_equal(yj, yt.numpy())
    tp = Te.pack_complex_cim_weights(torch.from_numpy(w.real.copy()),
                                     torch.from_numpy(w.imag.copy()))
    jp = Je.pack_complex_cim_weights(jnp.asarray(w.real), jnp.asarray(w.imag))
    np.testing.assert_array_equal(
        np.asarray(Jm.complex_cim_matmul(jnp.asarray(x), jp)),
        Tm.complex_cim_matmul(torch.from_numpy(x), tp).numpy())
    np.testing.assert_array_equal(
        np.asarray(Jk.ccim_complex_matmul(jnp.asarray(x), jnp.asarray(w),
                                          use_pallas=True, interpret=True)),
        Tk.ccim_complex_matmul(torch.from_numpy(x),
                               torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("nd,adc,acc", [(2, 7, 16), (3, 8, 16), (3, 7, 32)])
def test_four_pass_route_off_prototype(nd, adc, acc):
    """Design points the fused kernels do not take run four real macro
    GEMMs on both sides; raw and packed agree with the reference."""
    jc = Jc.CCIMConfig(n_dcim_products=nd, adc_bits=adc, acc_len=acc)
    tc = Tc.CCIMConfig(n_dcim_products=nd, adc_bits=adc, acc_len=acc)
    assert not Tc._kernel_numerics_match(tc)
    assert not Jc._kernel_numerics_match(jc)
    xr, xi, wr, wi = _operands(7, 50, 13)
    j, t = jnp.asarray, torch.from_numpy
    RK.reset_launch_counts()
    K.reset_launch_counts()
    port = Tm.complex_cim_matmul_int(t(xr), t(xi), t(wr), t(wi), tc)
    _eq(Jm.complex_cim_matmul_int(j(xr), j(xi), j(wr), j(wi), None, jc),
        port)
    rng = np.random.default_rng(nd + adc + acc)
    x, w = _complex(rng, 7, 50), _complex(rng, 50, 13)
    jp = Je.pack_complex_cim_weights(j(w.real), j(w.imag), jc)
    tp = Te.pack_complex_cim_weights(t(w.real.copy()), t(w.imag.copy()), tc)
    np.testing.assert_array_equal(
        np.asarray(Jm.complex_cim_matmul(j(x), jp, jc)),
        Tm.complex_cim_matmul(t(x), tp, tc).numpy())
    # CPU tensors: plain versions only, no kernel counted
    assert K.ccim_complex_unpacked_cuda.launches == 0
    assert RK.ccim_matmul_prepacked_general_cuda.launches == 0


def test_noise_key_and_bad_operands_raise():
    x = torch.zeros((2, 16), dtype=torch.int32)
    w = torch.zeros((16, 3), dtype=torch.int32)
    # a noise key is a core.prng key: anything else is refused; a key
    # takes the four noisy sub-MACs and gives the reference's ints (every
    # fidelity, raw and packed: tests/test_torch_die_noise.py)
    with pytest.raises(ValueError, match="key"):
        Tm.complex_cim_matmul_int(x, x, w, w, noise_key=torch.zeros(3))
    with pytest.raises(ValueError, match="key"):
        Tm.complex_cim_matmul(torch.zeros((2, 16), dtype=torch.complex64),
                              torch.zeros((16, 3), dtype=torch.complex64),
                              noise_key=torch.zeros(3))
    xr, xi, wr, wi = _operands(4, 37, 5)
    want = jax.jit(lambda a, b, c, d, k: Jm.complex_cim_matmul_int(
        a, b, c, d, None, Jc.DEFAULT_CONFIG, k, use_pallas=False))(
        *(jnp.asarray(v) for v in (xr, xi, wr, wi)), jax.random.PRNGKey(3))
    got = Tm.complex_cim_matmul_int(
        *(torch.from_numpy(v) for v in (xr, xi, wr, wi)),
        noise_key=torch.tensor([0, 3], dtype=torch.int64))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with pytest.raises(ValueError, match="raw"):
        Tm.complex_cim_matmul_int(x, x, w)
    p = Te.pack_complex_cim_weights(torch.randn(16, 3), torch.randn(16, 3))
    with pytest.raises(ValueError, match="raw"):
        Tm.complex_cim_matmul_int(x, x, p, w)
    with pytest.raises(ValueError, match="served with"):
        Tm.complex_cim_matmul_int(x, x, p, None, Tc.CCIMConfig(acc_len=32))


def test_cpu_tensors_take_the_plain_version():
    xr, xi, wr, wi = map(torch.from_numpy, _operands(4, 32, 5))
    with pytest.raises(ValueError, match="CUDA tensors"):
        Tk.ccim_complex_matmul_int(xr, xi, wr, wi, use_kernel=True)
    i8 = lambda v: v.to(torch.int8)
    p = Te.pack_complex_cim_weights(torch.randn(32, 5), torch.randn(32, 5))
    for wrapper, args in (
            (K.ccim_complex_unpacked_cuda, (i8(xr), i8(xi), i8(wr), i8(wi))),
            (K.ccim_complex_prepacked_skinny_cuda,
             (i8(xr), i8(xi), p.re.kernel_w, p.re.kernel_planes,
              p.im.kernel_w, p.im.kernel_planes)),
            (K.ccim_complex_prepacked_general_cuda,
             (i8(xr), i8(xi), p.re.kernel_w, p.re.kernel_planes,
              p.im.kernel_w, p.im.kernel_planes))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            wrapper(*args)
    assert K.ccim_complex_prepacked_skinny_cuda.launches == 0


@pytest.mark.parametrize("src,fn", [
    ("ccim_complex_skinny.cu", "ccim_complex_matmul_prepacked_skinny_pallas"),
    ("ccim_complex_general.cu", "ccim_complex_matmul_prepacked_pallas"),
    ("ccim_complex_unpacked.cu", "ccim_complex_matmul_pallas")])
def test_kernel_sources_name_what_they_replace(src, fn):
    text = (Path(K.__file__).parent / "csrc" / src).read_text()
    assert "Replaces:" in text and fn in text
    assert "What bounds it" in text and "Design:" in text
