"""Card-only tests of the port's CUDA kernels against their plain version.

They need an NVIDIA GPU and skip elsewhere (the reason names the missing
device).  This file imports no JAX, so it runs on a machine with only
the port's dependencies:

  PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
      tests/test_torch_cuda.py

Integer outputs are compared with torch.equal: the kernels and the plain
version compute the same integers, so there is no tolerance.
"""
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.ccim import CCIMConfig
from repro_torch.kernels.ccim_matmul import kernel as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _ints(gen, shape, dev):
    return torch.randint(-127, 128, shape, generator=gen, device=dev,
                         dtype=torch.int32)


@pytest.mark.parametrize("acc_len", [8, 16, 32, 64])
@pytest.mark.parametrize("n_dcim", [0, 3, 6])
@pytest.mark.parametrize("m", [1, 5, 32, 33, 100])
def test_kernel_equals_plain(dev, acc_len, n_dcim, m):
    gen = torch.Generator(device=dev)
    gen.manual_seed(acc_len * 100 + n_dcim * 10 + m)
    cfg = CCIMConfig(n_dcim_products=n_dcim, acc_len=acc_len, adc_bits=8)
    p = engine.pack_quantized_cim_weights(
        _ints(gen, (520, 70), dev), torch.ones((1, 70), device=dev), cfg)
    x = _ints(gen, (m, 520), dev)
    y_k = engine.packed_cim_matmul_int(x, p, cfg=cfg)
    y_p = engine.packed_cim_matmul_int(x, p, cfg=cfg, use_kernel=False)
    assert torch.equal(y_k, y_p)


def test_dispatch_counts_launches(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = CCIMConfig()
    p = engine.pack_quantized_cim_weights(
        _ints(gen, (64, 48), dev), torch.ones((1, 48), device=dev), cfg)
    K.reset_launch_counts()
    engine.packed_cim_matmul_int(_ints(gen, (4, 64), dev), p, cfg=cfg)
    engine.packed_cim_matmul_int(_ints(gen, (40, 64), dev), p, cfg=cfg)
    engine.packed_cim_matmul_int(_ints(gen, (4, 64), dev), p, cfg=cfg,
                                 use_kernel=False)
    assert K.ccim_matmul_prepacked_skinny_cuda.launches == 1
    assert K.ccim_matmul_prepacked_general_cuda.launches == 1


def test_analog_subset_of_hybrid_pack(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    hybrid = CCIMConfig(n_dcim_products=3)
    p = engine.pack_quantized_cim_weights(
        _ints(gen, (96, 40), dev), torch.ones((1, 40), device=dev), hybrid)
    subset = CCIMConfig(n_dcim_products=0, adc_bits=9)
    for m in (3, 50):
        x = _ints(gen, (m, 96), dev)
        assert torch.equal(
            engine.packed_cim_matmul_int(x, p, cfg=subset),
            engine.packed_cim_matmul_int(x, p, cfg=subset, use_kernel=False))
