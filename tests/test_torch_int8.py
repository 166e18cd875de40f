"""Port parity: the W8A8 GEMM (repro_torch/kernels/int8_matmul) against
the reference's ``repro.kernels.int8_matmul``, on the same numpy inputs.

Outputs are float32 and compared with ``==``: both sides quantize with
the same rounding points and take an exact integer dot, then the same
two float32 multiplies.  The CUDA kernel itself runs only on a GPU
(tests/test_torch_cuda.py, chip_smoke.py); here CPU tensors take the
plain version, and the test holds the plain version on the kernel's own
operand layout to the reference's Pallas kernel in interpret mode.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.int8_matmul import int8_matmul as j_int8_matmul
from repro.kernels.int8_matmul import int8_matmul_pallas as j_pallas
from repro.kernels.int8_matmul import int8_matmul_ref as j_ref
from repro_torch.kernels import build
from repro_torch.kernels.int8_matmul import kernel as KK
from repro_torch.kernels.int8_matmul import ops as O
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    """The same values on both sides: numpy -> jnp in ``dtype``, and the
    jnp array's exact values -> torch in ``dtype``."""
    v = jnp.asarray((rng.standard_normal(shape)
                     * rng.uniform(0.05, 20)).astype(np.float32),
                    DTYPES[dtype][0])
    t = torch.from_numpy(np.array(v.astype(jnp.float32))).to(DTYPES[dtype][1])
    return v, t


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", [(5, 100, 17), (33, 1041, 40),
                                   (1, 2304, 9), (130, 64, 129)])
def test_int8_matmul_equals_reference(dtype, m, k, n):
    """The reference's default CPU route (``use_pallas=False``, jitted)."""
    rng = np.random.default_rng(m * 7 + k + n)
    xj, xt = _pair(rng, (m, k), dtype)
    wj, wt = _pair(rng, (k, n), dtype)
    want = np.asarray(j_int8_matmul(xj, wj, use_pallas=False))
    got = O.int8_matmul(xt, wt)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())
    # the kernel's operand layout (K padded, w transposed) under the
    # plain version gives the same floats
    xq, sx = O.dynamic_quantize(xt, -1)
    wq, sw = O.dynamic_quantize(wt, 0)
    ops = O.kernel_operands(xq, sx, wq, sw)
    assert ops[0].shape[1] % KK.K_STEP == 0 and ops[1].shape == (
        n, ops[0].shape[1])
    assert torch.equal(KK.int8_w8a8_plain(*ops), got)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_matmul_equals_reference_pallas_route(dtype):
    """The reference's Pallas route in interpret mode at a block-aligned
    shape; for bf16 both routes dequantize with the float32 scale, not
    the bf16-rounded one (the rounding the port reproduces)."""
    rng = np.random.default_rng(11)
    xj, xt = _pair(rng, (128, 512), dtype)
    wj, wt = _pair(rng, (512, 128), dtype)
    want = np.asarray(j_int8_matmul(xj, wj, use_pallas=True, interpret=True))
    got = O.int8_matmul(xt, wt)
    np.testing.assert_array_equal(want, got.numpy())
    if dtype == "bfloat16":
        xq, sx = O.dynamic_quantize(xt, -1)
        wq, sw = O.dynamic_quantize(wt, 0)
        rounded = int8_matmul_ref(xq, wq, sx.to(torch.bfloat16),
                                  sw.to(torch.bfloat16))
        assert not torch.equal(rounded, got)


def test_plain_equals_pallas_interpret():
    """int8_matmul_pallas (interpret mode) on int8 operands and float32
    scales against the plain version on the kernel's layout, and the
    plain oracles against each other."""
    rng = np.random.default_rng(3)
    M, K, N = 128, 1024, 256
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    sx = rng.uniform(1e-3, 1, (M, 1)).astype(np.float32)
    sw = rng.uniform(1e-3, 1, (1, N)).astype(np.float32)
    want = np.asarray(j_pallas(*(jnp.asarray(v) for v in (xq, wq, sx, sw)),
                               interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(j_ref(*(jnp.asarray(v) for v in (xq, wq, sx, sw)))))
    t = [torch.from_numpy(v) for v in (xq, wq, sx, sw)]
    np.testing.assert_array_equal(want, int8_matmul_ref(*t).numpy())
    got = KK.int8_w8a8_plain(t[0], t[1].t().contiguous(), t[2].reshape(-1),
                             t[3].reshape(-1))
    np.testing.assert_array_equal(want, got.numpy())


def test_exact_dot_past_float32():
    """K * 127^2 passes 2^24 from K = 1,041: the plain dot stays exact."""
    K = 5760
    x = torch.full((1, K), 127, dtype=torch.int8)
    w = torch.full((K, 1), 127, dtype=torch.int8)
    w[-1, 0] = 126
    one = torch.ones((1, 1))
    want = float(np.float32(K * 127 * 127 - 127))
    assert float(int8_matmul_ref(x, w, one, one)) == want


def test_cpu_tensors_take_the_plain_version():
    x, w = torch.randn(3, 70), torch.randn(70, 5)
    KK.reset_launch_counts()
    y = O.int8_matmul(x, w)
    assert y.shape == (3, 5) and KK.int8_w8a8_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        O.int8_matmul(x, w, use_kernel=True)
    xq, sx = O.dynamic_quantize(x, -1)
    wq, sw = O.dynamic_quantize(w, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        KK.int8_w8a8_cuda(*O.kernel_operands(xq, sx, wq, sw))
    assert KK.int8_w8a8_cuda.launches == 0


def test_kernel_source_names_what_it_replaces():
    src = Path(KK.__file__).parent / "csrc" / "int8_w8a8.cu"
    text = src.read_text()
    assert "Replaces:" in text and "int8_matmul_pallas" in text
    assert "What bounds it" in text and "Design:" in text
    assert build.SOURCES["int8"] == "int8_matmul/csrc/int8_w8a8.cu"
    assert (Path(build.__file__).parent / build.SOURCES["int8"]).exists()


# minicpm-2b's four full-width layer GEMMs (K, N), and the card's SMs
FULL_WIDTH = {"qkv": (2304, 9216), "wo": (3072, 2304),
              "gate_up": (2304, 11520), "w2": (5760, 2304)}
H100_SMS = 132
PLAN_SHAPES = ([(m, k, n) for (k, n) in FULL_WIDTH.values()
                for m in (1, 4, 16, 32, 128, 256, 512)]
               + [(5, 100, 17), (33, 130, 2304), (1, 64, 1), (129, 70, 129),
                  (600, 5000, 7)])


def _covered_once(extent: int, tiles: int, width: int) -> bool:
    counts = np.zeros(tiles * width, dtype=np.int64)
    for t in range(tiles):
        counts[t * width:(t + 1) * width] += 1
    return (tiles - 1) * width < extent and bool((counts[:extent] == 1).all())


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_int8_plan_covers_every_output_once(m, k, n):
    """The kernel's tile/split plan: token and weight tiles cover every
    output once, the K slices cut Kp in whole 64-byte steps with no gap,
    overlap or empty slice, a cluster has at most 8 blocks, two blocks
    fit an SM, and each
    full-width shape puts at least one block on every SM of the card."""
    kp = -(-k // KK.K_STEP) * KK.K_STEP
    p = KK.plan(m, n, kp, H100_SMS)
    assert p.tok in KK.TOKS and (p.tok >= m or p.m_tiles > 1)
    assert _covered_once(m, p.m_tiles, p.tok)
    assert _covered_once(n, p.n_tiles, KK.BN)
    ranges = p.k_ranges(kp)
    assert len(ranges) == p.splits and 1 <= p.splits <= KK.MAX_SPLITS
    assert ranges[0][0] == 0 and ranges[-1][1] == kp
    assert all(hi == lo for (_, hi), (lo, _) in zip(ranges, ranges[1:]))
    assert all(lo < hi and lo % KK.K_STEP == 0 and hi % KK.K_STEP == 0
               for lo, hi in ranges)
    assert p.k_stages * KK.K_STAGE >= kp > (p.k_stages - 1) * KK.K_STAGE
    assert 2 <= p.ring <= KK.MAX_RING
    # the block's dynamic shared memory: 1 KB alignment slack, the ring or
    # the parked partial tile (the larger), a full and an empty barrier a
    # stage; 1 KB more is the system's
    ring = max(p.ring * (KK.BN + p.tok) * KK.K_STAGE,
               p.tok * KK.STAGING_PITCH * 4)
    smem = 1024 + ring + 16 * p.ring
    assert KK.BLOCKS_PER_SM * (smem + 1024) <= 228 * 1024
    if (k, n) in FULL_WIDTH.values():
        assert p.blocks >= H100_SMS


@pytest.mark.parametrize("sms", [8, H100_SMS])
@pytest.mark.parametrize("m,k,n", [(5, 100, 17), (33, 130, 2304),
                                   (4, 3072, 40), (128, 5760, 24),
                                   (130, 64, 129), (257, 1000, 33),
                                   (4, 3072, 2304)])
def test_int8_kernel_arithmetic_equals_plain(m, k, n, sms):
    """An integer model of the kernel: int32 partial sums over the plan's
    K slices, added (in any order: int32 is exact), then the two float32
    roundings; it equals the plain version with ``==``."""
    rng = np.random.default_rng(m + k + n + sms)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    sx = torch.from_numpy(rng.uniform(1e-3, 2, (m, 1)).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(1e-3, 2, (1, n)).astype(np.float32))
    x, w, sxf, swf = O.kernel_operands(xq, sx, wq, sw)
    p = KK.plan(m, n, x.shape[1], sms)
    acc = torch.zeros((m, n), dtype=torch.int32)
    for lo, hi in reversed(p.k_ranges(x.shape[1])):
        part = x[:, lo:hi].long() @ w[:, lo:hi].long().t()
        assert int(part.abs().max()) < 2 ** 31
        acc += part.to(torch.int32)
    got = (acc.to(torch.float32) * sxf[:, None]) * swf[None, :]
    assert torch.equal(got, int8_matmul_ref(xq, wq, sx, sw))
    assert torch.equal(got, KK.int8_w8a8_plain(x, w, sxf, swf))
