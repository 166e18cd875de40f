"""Port parity: repro_torch.core.prng against jax.random (threefry2x32,
``jax_threefry_partitionable`` on, as jax 0.9.0 has it by default).

Keys, bits and uniforms are integer or exact float work: they must equal
jax's with ``==``.  Normals and Gumbels go through float32 ``log1p``,
``log``, ``sqrt`` and ``erf_inv``; the port evaluates XLA's CPU
approximations of those operation for operation (``prng.log``,
``prng.log1p``, fused multiply-adds where XLA's CPU compiler fuses
them), so over the draws below they differ from jax's in no element:
the stated residue, ``NORMAL_RESIDUE`` and ``CATEGORICAL_RESIDUE``, is
0.  (Evaluated with torch's own float32 ``log1p`` and ``sqrt`` instead,
10,233 of the 2^20 normals differed, by up to 3 ulps; the ``log``
of the Gumbels, 240,093 of 2^20 by 1 ulp.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng as P

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 32 - 1, -1]
SHAPES = [(), (3,), (5, 7, 11), (2 ** 16 + 3,)]
# elements that may differ from jax's, of 2^20 normals / 10,000 rows
NORMAL_RESIDUE = 0
CATEGORICAL_RESIDUE = 0


def _j(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _t(key) -> torch.Tensor:
    return torch.from_numpy(_j(key))


def test_partitionable_threefry_is_jax_default():
    """The port implements the partitionable scheme only: a change of
    jax's default must show here, not as a silent mismatch."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), P.PRNGKey(seed)
    assert np.array_equal(_j(jk), tk.numpy())
    assert tk.tolist() == [0, seed % 2 ** 32]
    for data in (0, 1, 0x53414D50, 2 ** 31 + 3, 2 ** 32 - 1):
        assert np.array_equal(_j(jax.random.fold_in(jk, data)),
                              P.fold_in(tk, data).numpy())
    for n in (2, 3, 4):
        assert np.array_equal(_j(jax.random.split(jk, n)),
                              P.split(tk, n).numpy())


@pytest.mark.parametrize("n", [2, 3])
def test_batched_split_and_fold_in_equal_vmap(n):
    """A (B, 2) batch of keys splits as ``jax.vmap(jax.random.split)``
    does and as B separate splits do; fold_in broadcasts data over it."""
    jks = jax.random.split(jax.random.PRNGKey(11), 5)
    tks = _t(jks)
    got = P.split(tks, n)
    assert np.array_equal(_j(jax.vmap(lambda k: jax.random.split(k, n))(jks)),
                          got.numpy())
    for b in range(5):
        assert torch.equal(got[b], P.split(tks[b], n))
    rids = torch.arange(5)
    assert np.array_equal(
        _j(jax.vmap(jax.random.fold_in)(jks, jnp.arange(5))),
        P.fold_in(tks, rids).numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_equal_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), P.PRNGKey(seed)
    assert np.array_equal(np.asarray(jax.random.bits(jk, shape)).astype(
        np.int64), P.bits(tk, shape).numpy())
    assert np.array_equal(np.asarray(jax.random.uniform(jk, shape)),
                          P.uniform(tk, shape).numpy())
    for lo, hi in ((-3.0, 5.0), (0.3, 1.7), (float(np.finfo(np.float32).tiny),
                                             1.0)):
        assert np.array_equal(
            np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi)),
            P.uniform(tk, shape, lo, hi).numpy()), (lo, hi)


def test_bits_at_is_a_slice_of_bits():
    """``bits_at`` draws any re-layout of a draw: the fast GEMM's noise
    blocks rest on it."""
    tk = P.PRNGKey(3)
    full = P.bits(tk, (4, 5, 6))
    idx = torch.arange(4 * 5 * 6).reshape(4, 5, 6).permute(2, 0, 1)[1:4]
    assert torch.equal(P.bits_at(tk, idx), full.permute(2, 0, 1)[1:4])


@pytest.mark.parametrize("seed", [0, 2 ** 32 - 1])
def test_normal_equals_jax_up_to_the_stated_residue(seed):
    jk, tk = jax.random.PRNGKey(seed), P.PRNGKey(seed)
    want = np.asarray(jax.random.normal(jk, (2 ** 20,)))
    got = P.normal(tk, (2 ** 20,)).numpy()
    differ = want != got
    assert int(differ.sum()) <= NORMAL_RESIDUE
    ulps = np.abs(want.view(np.int32).astype(np.int64)
                  - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2
    # the tails exercise erf_inv's w >= 5 polynomial and log1p's log branch
    assert np.abs(got).max() > 4.5


def test_gumbel_and_erf_inv_edges_equal_jax():
    jk, tk = jax.random.PRNGKey(5), P.PRNGKey(5)
    assert np.array_equal(np.asarray(jax.random.gumbel(jk, (2 ** 18,))),
                          P.gumbel(tk, (2 ** 18,)).numpy())
    x = np.float32([-1.0, 1.0, 0.0, -0.5, 0.999999, 1e-30])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = P.erf_inv(torch.from_numpy(x)).numpy()
    assert np.array_equal(want, got)
    v = np.float32([0.0, 1e-45, 1e-38, 0.5, 1.0, 3.0e38, np.inf])
    assert np.array_equal(np.asarray(jnp.log(jnp.asarray(v))),
                          P.log(torch.from_numpy(v)).numpy())


@pytest.mark.parametrize("per_row", [False, True])
def test_categorical_equals_jax_up_to_the_stated_residue(per_row):
    """10,000 rows at the smoke vocab (512): one key for the batch, as the
    lock-step sampler draws, or one key per row, as the scheduler's
    ``vmap`` draws."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((10_000, 512)) * 3).astype(np.float32)
    jk = jax.random.PRNGKey(9)
    if per_row:
        jks = jax.random.split(jk, 10_000)
        want = jax.vmap(jax.random.categorical)(jks, jnp.asarray(logits))
        got = P.categorical(_t(jks), torch.from_numpy(logits))
    else:
        want = jax.random.categorical(jk, jnp.asarray(logits))
        got = P.categorical(_t(jk), torch.from_numpy(logits))
    assert int((np.asarray(want) != got.numpy()).sum()) <= CATEGORICAL_RESIDUE


RANDINT_RANGES = [(-127, 128), (0, 1), (5, 5), (9, 3), (0, 10),
                  (-1000, 1000), (-2 ** 31, 2 ** 31 - 1),
                  (-2 ** 31, -2 ** 31 + 7), (0, 2 ** 31), (-5, 2 ** 40),
                  (2 ** 31 - 2, 2 ** 33)]


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("lo,hi", RANDINT_RANGES)
def test_randint_equals_jax(seed, lo, hi):
    """int32 draws in [lo, hi): span 1 where hi <= lo, the int32 limits,
    and a maxval above int32's range (which jax takes as a 64-bit bound
    with ``dtype=int32``, under x64)."""
    jk, tk = jax.random.PRNGKey(seed), P.PRNGKey(seed)
    for shape in ((), (3,), (5, 7), (1000, 16)):
        if hi > 2 ** 31 - 1:
            with jax.enable_x64(True):
                want = jax.random.randint(jk, shape, lo, hi, dtype=jnp.int32)
        else:
            want = jax.random.randint(jk, shape, lo, hi)
        got = P.randint(tk, shape, lo, hi)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        assert np.array_equal(np.asarray(want), got.numpy()), shape


def test_randint_and_normal_are_partitionable():
    """A draw of more rows holds the smaller draw as its first rows (the
    card's 2^20 Fig. 6 conversions start with the reference's 16,384)."""
    k = P.PRNGKey(0)
    assert torch.equal(P.randint(k, (1 << 14, 16), -127, 128),
                       P.randint(k, (1 << 16, 16), -127, 128)[:1 << 14])
    assert torch.equal(P.normal(k, (100, 16)), P.normal(k, (300, 16))[:100])


def test_key_checks():
    with pytest.raises(ValueError, match="uint32"):
        P.fold_in(P.PRNGKey(0), -1)
    with pytest.raises(ValueError, match="key"):
        P.bits(torch.zeros(3, dtype=torch.int64), (2,))


def test_exp_equals_xla_cpu():
    """``prng.exp`` is XLA's CPU float32 exp (the decode softmax's):
    equal to jax's compiled exp bit for bit over the softmax's range,
    the clamps, the flushed tails and a wide normal spread."""
    rng = np.random.default_rng(7)
    v = np.concatenate([
        rng.uniform(-100.0, 10.0, 1 << 18), rng.uniform(-1.0, 1.0, 1 << 16),
        rng.standard_normal(1 << 16) * 5.0,
        [0.0, -0.0, -87.8, -87.7, -88.0, -1e30, 88.7, 88.8, 100.0]]
    ).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(v)))
    got = P.exp(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
