"""Port parity: the plain version of the port's prepacked macro GEMM
kernels (kernels/ccim_matmul) against the reference's Pallas kernels run
in interpret mode, and against the integer oracles.

All outputs are int32 and compared with ``==``.  The CUDA kernels
themselves run only on a GPU (tests/test_torch_cuda.py and
chip_smoke.py); here the dispatcher routes CPU tensors to the plain
version, and the wrappers refuse CPU tensors.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ccim as Jc
from repro.core import engine as Je
from repro.kernels.ccim_matmul import ccim_matmul_ref as jax_ref
from repro.kernels.ccim_matmul import ops as jops
from repro_torch.core import ccim as Tc
from repro_torch.core import engine as Te
from repro_torch.kernels.ccim_matmul import kernel as K
from repro_torch.kernels.ccim_matmul import ops as tops
from repro_torch.kernels.ccim_matmul.ref import ccim_matmul_ref as torch_ref

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("nd,adc,acc,m", [(3, 7, 16, 3), (3, 7, 16, 40),
                                          (0, 9, 8, 5), (6, 8, 64, 36)])
def test_plain_equals_pallas_interpret(nd, adc, acc, m):
    """Reference: ccim_matmul_int_prepacked with use_pallas=True in
    interpret mode (the skinny kernel at M <= 32, the general one
    above)."""
    jc = Jc.CCIMConfig(n_dcim_products=nd, adc_bits=adc, acc_len=acc)
    tc = Tc.CCIMConfig(n_dcim_products=nd, adc_bits=adc, acc_len=acc)
    rng = np.random.default_rng(nd + adc + acc + m)
    K_, N = 96, 40
    w = rng.integers(-127, 128, (K_, N)).astype(np.int32)
    x = rng.integers(-127, 128, (m, K_)).astype(np.int32)
    one = np.ones((1, N), np.float32)
    jp = Je.pack_quantized_cim_weights(jnp.asarray(w), jnp.asarray(one), jc)
    x_bits = tuple(Jc._dcim_by_j(jc))
    yj = jops.ccim_matmul_int_prepacked(
        jnp.asarray(x), jp.pallas_w, jp.pallas_planes, k_dim=K_, n_dim=N,
        acc_len=acc, x_bits=x_bits, dcim_lsb=jc.dcim_lsb, adc_bits=adc,
        use_pallas=True, interpret=True)
    tp = Te.pack_quantized_cim_weights(torch.from_numpy(w),
                                       torch.from_numpy(one), tc)
    yt = tops.ccim_matmul_int_prepacked(
        torch.from_numpy(x), tp.kernel_w, tp.kernel_planes, k_dim=K_,
        n_dim=N, acc_len=acc, x_bits=x_bits, dcim_lsb=tc.dcim_lsb,
        adc_bits=adc)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


@pytest.mark.parametrize("m,k,n", [(4, 64, 8), (33, 160, 20), (1, 2304, 3)])
def test_plain_equals_oracles_at_prototype_split(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = rng.integers(-127, 128, (m, k)).astype(np.int32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int32)
    ref_t = torch_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(
        np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w))), ref_t.numpy())
    p = Te.pack_quantized_cim_weights(torch.from_numpy(w),
                                      torch.ones((1, n)), Tc.DEFAULT_CONFIG)
    y = K.ccim_matmul_prepacked_plain(
        torch.from_numpy(x).to(torch.int8), p.kernel_w, p.kernel_planes)
    assert torch.equal(y, ref_t)


def test_weight_layout_pads_only_whole_chunks():
    for k in (2304, 3072, 5760):                  # minicpm-2b: no padding
        for acc in (8, 16, 32, 64):
            assert tops.weight_layout(k, 9216, acc) == (k, 9216)
    assert tops.weight_layout(100, 7, 8) == (112, 7)
    assert tops.weight_layout(100, 7, 64) == (128, 7)


def test_cpu_tensors_take_the_plain_version():
    p = Te.pack_cim_weights(torch.randn(48, 8))
    x = torch.randint(-127, 128, (2, 48), dtype=torch.int32)
    K.reset_launch_counts()
    y = tops.ccim_matmul_int_prepacked(x, p.kernel_w, p.kernel_planes,
                                       k_dim=48, n_dim=8)
    assert y.shape == (2, 8) and y.dtype == torch.int32
    assert K.ccim_matmul_prepacked_skinny_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.ccim_matmul_int_prepacked(x, p.kernel_w, p.kernel_planes,
                                       k_dim=48, n_dim=8, use_kernel=True)
    for wrapper in (K.ccim_matmul_prepacked_skinny_cuda,
                    K.ccim_matmul_prepacked_general_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            wrapper(x.to(torch.int8), p.kernel_w, p.kernel_planes)


def test_kernel_sources_name_what_they_replace():
    csrc = Path(K.__file__).parent / "csrc"
    for src, fn in (("ccim_prepacked_skinny.cu",
                     "ccim_matmul_prepacked_skinny_pallas"),
                    ("ccim_prepacked_general.cu",
                     "ccim_matmul_prepacked_pallas")):
        text = (csrc / src).read_text()
        assert "Replaces:" in text and fn in text
        assert "What bounds it" in text and "Design:" in text
