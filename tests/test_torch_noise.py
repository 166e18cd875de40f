"""Port parity: the macro's analog noise on the serving path.

The fast model adds one matched Gaussian per ADC conversion, its
variance ``coef * |acim| + floor`` from the magnitude dots, before the
ADC's floor and clip.  The port draws the reference's normals bit for
bit (``core/prng.py``) at the same flat indices, and evaluates the two
multiply-adds fused and the square root correctly rounded, as the
reference's compiled CPU code does; so the ADC codes, and every integer
after them, must equal the reference's with ``==`` (the reference runs
under ``jax.jit``, as it serves: run op by op, it rounds the analog sums
without fusing and a few of them differ in the last bit).  No code
differs over the cases below, so no count of differing codes is stated.

Covered: ``_fast_gemm_noise`` with and without segments; the noisy
``hybrid_mac_fast_gemm_prepacked`` (chunk blocking invisible),
``hybrid_mac_fast`` and the packed engine path, which leaves the
noise-free kernels for the chunked GEMM as the reference leaves its
Pallas kernels; fused == unfused projection groups
(``test_fused_noise_streams_bit_identical``'s counterpart); a planned
serve with noise; ``serve(noise_seed=0)`` and the scheduler under
``cim_noise_seed``; the refusal without CIM.
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
from repro.core.ccim import DEFAULT_CONFIG as J_DEFAULT
from repro.launch import scheduler as JS
from repro.launch.serve import serve as jserve
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax, plan_from_jax
from repro_torch.core import ccim as T
from repro_torch.core import engine as TE
from repro_torch.kernels.ccim_matmul import kernel as K
from repro_torch.launch import scheduler as TS
from repro_torch.launch.serve import serve as tserve
from repro_torch.models import lm as tlm

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

SHAPES = [(3, 5, 7), (17, 40, 33), (4, 144, 64)]      # (M, C, N)
SEGMENTS = (20, 5, 8)                                  # of N = 33


def _key(seed: int, data: int):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


def _operands(m, c, n, acc=16, seed=0):
    rng = np.random.default_rng(seed + m * c * n)
    return (rng.integers(-127, 128, (m, c, acc)).astype(np.int32),
            rng.integers(-127, 128, (c, acc, n)).astype(np.int32))


@pytest.mark.parametrize("segmented", [False, True])
def test_noise_draw_equals_reference(segmented):
    M, C, N = 17, 40, 33
    keys = [_key(1, i) for i in range(3 if segmented else 1)]
    segs = SEGMENTS if segmented else None
    jkey = tuple(k[0] for k in keys) if segmented else keys[0][0]
    tkey = tuple(k[1] for k in keys) if segmented else keys[0][1]
    want = np.asarray(J._fast_gemm_noise(jkey, M, N, C, segs))
    got = T._fast_gemm_noise(tkey, M, N, C, segs)
    assert np.array_equal(want, got.numpy())
    # a block of chunks is that block of the whole draw
    assert torch.equal(T._fast_gemm_noise(tkey, M, N, C, segs, 7, 19),
                       got[7:19])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cfg_kw", [{}, dict(n_dcim_products=0, adc_bits=9),
                                    dict(n_dcim_products=5, acc_len=32)])
def test_noisy_fast_gemm_ints_equal_reference(shape, cfg_kw):
    M, C, N = shape
    jc, tc = J.CCIMConfig(**cfg_kw), T.CCIMConfig(**cfg_kw)
    xq, wq = _operands(M, C, N, jc.acc_len)
    jk, tk = _key(0, 12345)
    want = jax.jit(lambda x, w, k: J.hybrid_mac_fast_gemm(x, w, k, jc))(
        jnp.asarray(xq), jnp.asarray(wq), jk)
    x, w = torch.from_numpy(xq), torch.from_numpy(wq)
    got = T.hybrid_mac_fast_gemm(x, w, tk, tc)
    assert np.array_equal(np.asarray(want), got.numpy())
    clean = T.hybrid_mac_fast_gemm(x, w, None, tc)
    assert not torch.equal(got, clean)          # the noise moved codes
    wf, w_pl = T.fast_gemm_weight_ops(w, tc)
    for cb in (1, 7):                  # the chunk blocks schedule only
        assert torch.equal(got, T.fast_gemm_int(
            x, wf, w_pl, tuple(T._dcim_by_j(tc)), tc.dcim_lsb,
            tc.adc_half_range, cb, noise_key=tk, cfg=tc))


def test_segmented_noisy_gemm_equals_reference():
    M, C, N = 17, 40, 33
    xq, wq = _operands(M, C, N)
    keys = [_key(2, i) for i in range(3)]
    jk, tk = tuple(k[0] for k in keys), tuple(k[1] for k in keys)
    want = jax.jit(lambda x, w, k: J.hybrid_mac_fast_gemm(
        x, w, k, J_DEFAULT, SEGMENTS))(jnp.asarray(xq), jnp.asarray(wq), jk)
    wf, w_pl = T.fast_gemm_weight_ops(torch.from_numpy(wq))
    got = T.hybrid_mac_fast_gemm_prepacked(torch.from_numpy(xq), wf, w_pl,
                                           tk, T.DEFAULT_CONFIG, SEGMENTS)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_noisy_mac_fast_equals_reference(shape):
    M, C, N = shape
    xq, wq = _operands(M, C, N)
    xb, wb = xq[:, None], np.ascontiguousarray(wq.transpose(2, 0, 1)[None])
    jk, tk = _key(0, 77)
    want = jax.jit(lambda x, w, k: J.hybrid_mac_fast(x, w, k))(
        jnp.asarray(xb), jnp.asarray(wb), jk)
    got = T.hybrid_mac_fast(torch.from_numpy(xb), torch.from_numpy(wb), tk)
    for key in ("y8", "adc_code", "a_real"):
        assert np.array_equal(np.asarray(want[key]), got[key].numpy()), key


def test_packed_noisy_path_equals_reference_and_skips_kernels():
    """The engine's noisy 'fast' GEMM on a pack (int8 views, no float
    copy) equals the reference's; the noise-free kernels are not called,
    and 'exact' ignores the key."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((200, 48)).astype(np.float32)
    x = rng.integers(-127, 128, (6, 200)).astype(np.int32)
    jp = JE.pack_cim_weights(jnp.asarray(w))
    tp = TE.pack_cim_weights(torch.from_numpy(w))
    jk, tk = _key(4, 9)
    want = jax.jit(lambda a, k: JE.packed_cim_matmul_int(
        a, jp, None, J_DEFAULT, k))(jnp.asarray(x), jk)
    K.reset_launch_counts()
    got = TE.packed_cim_matmul_int(torch.from_numpy(x), tp, noise_key=tk)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert K.ccim_matmul_prepacked_skinny_cuda.launches == 0
    exact = TE.packed_cim_matmul_int(torch.from_numpy(x), tp,
                                     noise_key=tk, fidelity="exact")
    assert torch.equal(exact, TE.packed_cim_matmul_int(
        torch.from_numpy(x), tp, fidelity="exact"))


# -- the model --------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tcfg, "cpu")
    return jp, jcfg, tp, tcfg


def _prefill_logits(params, cfg, toks):
    with torch.inference_mode():
        cache = tlm.init_cache(cfg, toks.shape[0], toks.shape[1],
                               device="cpu")
        return tlm.prefill(params, cfg, toks, cache)[0]


def test_fused_noise_streams_bit_identical(models):
    """Each segment of a fused group draws its own projection's stream:
    fused logits equal unfused ones, and differ from noise-free ones."""
    _, _, tp, tcfg = models
    on = dataclasses.replace(tcfg, cim_noise_seed=13)
    off = dataclasses.replace(on, cim_fuse=False)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 12))).long()
    fused = _prefill_logits(tlm.pack_cim_params(tp, on, "cpu"), on, toks)
    unfused = _prefill_logits(tlm.pack_cim_params(tp, off, "cpu"), off, toks)
    assert torch.equal(fused, unfused)
    clean = _prefill_logits(tlm.pack_cim_params(tp, tcfg, "cpu"), tcfg, toks)
    assert not torch.equal(fused, clean)


J_MIXED = JP.DeploymentPlan.from_dict({
    "mlp/w3": JP.FLOAT_ENTRY, "mlp/w2": JP.DIGITAL_ENTRY,
    "attn/wo": JP.PlanEntry(cfg=dataclasses.replace(
        J_DEFAULT, n_dcim_products=5, adc_bits=8), label="h5")},
    default=JP.HYBRID_ENTRY)


@pytest.fixture(scope="module")
def reference(models):
    """The reference's noisy tokens: lock-step at noise seed 0, under the
    mixed plan at seed 7, and its scheduler under cim_noise_seed 3."""
    jp, jcfg, _, _ = models
    kw = dict(smoke=True, batch=2, prompt_len=8, gen=6)
    noisy = np.asarray(jserve("minicpm-2b", cim=True, noise_seed=0, **kw))
    planned = np.asarray(jserve("minicpm-2b", plan=J_MIXED, noise_seed=7,
                                **kw))
    ncfg = dataclasses.replace(jcfg, cim_noise_seed=3)
    reqs = TS.mixed_length_requests(4, 8, 512, stop_lengths=(2, 5, 3),
                                    seed=1)
    pool = JS.ContinuousBatchingScheduler(
        jlm.pack_cim_params(jp, ncfg), ncfg, slots=2, prompt_len=8,
        max_new_cap=5).run([JS.Request(rid=r.rid, prompt=r.prompt,
                                       max_new_tokens=r.max_new_tokens)
                            for r in reqs])
    return noisy, planned, pool.tokens_by_rid(), reqs


def test_noisy_serve_equals_reference(models, reference):
    _, _, tp, _ = models
    noisy, planned, _, _ = reference
    kw = dict(smoke=True, batch=2, prompt_len=8, gen=6, device="cpu",
              params=tp)
    got, st = tserve("minicpm-2b", cim=True, noise_seed=0,
                     return_stats=True, **kw)
    np.testing.assert_array_equal(got, noisy)
    assert st["noise_seed"] == 0
    assert not np.array_equal(got, tserve("minicpm-2b", cim=True, **kw))
    # the planned forward: each projection its own entry and stream
    got = tserve("minicpm-2b", plan=plan_from_jax(J_MIXED), noise_seed=7,
                 **kw)
    np.testing.assert_array_equal(got, planned)


def test_noisy_scheduler_equals_reference(models, reference):
    """Noise is drawn per pool row; the same pool on the same slots
    serves the reference's tokens."""
    _, _, tp, tcfg = models
    _, _, want, reqs = reference
    ncfg = dataclasses.replace(tcfg, cim_noise_seed=3)
    got = TS.ContinuousBatchingScheduler(
        tlm.pack_cim_params(tp, ncfg, "cpu"), ncfg, slots=2, prompt_len=8,
        max_new_cap=5).run(reqs).tokens_by_rid()
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))


def test_noise_needs_cim():
    with pytest.raises(ValueError, match="needs\\s+cim=True"):
        tserve("minicpm-2b", smoke=True, batch=2, prompt_len=8, gen=3,
               noise_seed=7, device="cpu")
