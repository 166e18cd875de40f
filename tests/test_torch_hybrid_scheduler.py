"""Port parity: serving the hybrid family (zamba2-1.2b smoke: 4 Mamba2
layers, the shared attn + mlp block after layers 2 and 4) against the
reference, with weights from the reference ``lm.init`` through
``convert.params_from_jax``; the model-level parity and the counted
residues are in ``test_torch_hybrid.py``.

Greedy tokens ``==`` the reference's ``serve`` in float, packed fused
and unfused, unpacked and noisy CIM mode, and sampled ones at T 0.7; the scheduler's refilled pool
``==`` solo runs and the reference's pool; the paged pool (the shared
block's KV paged, the recurrent state per slot) with chunked prefill
``==`` the contiguous pool at temperature 0.7; the recurrent families'
rules (no speculative decoding, paged prompts a whole number of chunks,
no prefix sharing) and the slot reset.  Each reference scheduler runs
once per module (a fixture).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import scheduler as JS
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.launch import scheduler as TS
from repro_torch.launch.paging import PagedLayout as TLayout
from repro_torch.launch.serve import serve_speculative
from repro_torch.models import lm as tlm

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

ARCH = "zamba2-1.2b"


def _f32(tree):
    return jax.tree.map(lambda v: np.asarray(v.astype(jax.numpy.float32)),
                        tree)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jget(ARCH, smoke=True), tget(ARCH, smoke=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_f32(jp), tcfg, "cpu")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the scheduler: refill == solo, paged chunked == contiguous, rules
# ---------------------------------------------------------------------------

P, CAP = 8, 6


def _jreqs(reqs):
    return [JS.Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens,
                       stop_token=r.stop_token) for r in reqs]


def _refill_requests():
    return TS.mixed_length_requests(6, P, 512, stop_lengths=(2, 6, 3, 5))


def _paged_requests(plen):
    rng = np.random.default_rng(4)
    return [TS.Request(rid=i, prompt=rng.integers(0, 512, plen,
                                                  dtype=np.int32),
                       max_new_tokens=(6, 9)[i % 2], stop_token=3)
            for i in range(4)]


SAMPLED = dict(slots=2, max_new_cap=10, temperature=0.7, seed=5)


@pytest.fixture(scope="module")
def ref_runs(model):
    """The reference's refilled pool (float weights, 2 slots) and its
    contiguous pools at T 0.7 over prompts of 16 and of 32 (the paged
    tests' baselines)."""
    jcfg, _, jp, _ = model
    refill = JS.ContinuousBatchingScheduler(
        jp, jcfg, slots=2, prompt_len=P, max_new_cap=CAP).run(
        _jreqs(_refill_requests()))
    sampled = {plen: JS.ContinuousBatchingScheduler(
        jp, jcfg, prompt_len=plen, **SAMPLED).run(
        _jreqs(_paged_requests(plen))).tokens_by_rid() for plen in (16, 32)}
    return refill.tokens_by_rid(), sampled


def _assert_tokens_equal(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_refill_equals_solo_and_reference(model, ref_runs):
    """Three times more requests than slots: every slot is refilled
    mid-stream (its SSM, conv and shared-KV state reset), and each
    request's tokens equal its solo run and the reference's pool."""
    _, tcfg, _, tp = model
    reqs = _refill_requests()
    report = TS.ContinuousBatchingScheduler(
        tp, tcfg, slots=2, prompt_len=P, max_new_cap=CAP).run(reqs)
    assert report.n_admits == len(reqs)
    got = report.tokens_by_rid()
    _assert_tokens_equal(got, ref_runs[0])
    solo = TS.ContinuousBatchingScheduler(tp, tcfg, slots=1, prompt_len=P,
                                          max_new_cap=CAP)
    for r in reqs:
        np.testing.assert_array_equal(
            solo.run([r]).tokens_by_rid()[r.rid], got[r.rid])


@pytest.mark.parametrize("plen,chunk", [(16, 8), (32, 32)])
def test_paged_chunked_equals_contiguous_sampled(model, ref_runs, plen,
                                                 chunk):
    """The twin of tests/test_paging.py::test_paged_recurrent_families_bit_exact
    (prompts 16, chunks 8) and the same at one SSD chunk (prompts 32,
    chunks 32), at T 0.7: the shared block's KV is paged, the recurrent
    state rides per-slot dense buffers that pool steps between a slot's
    chunks must not touch, and the tokens equal the contiguous pool's
    and the reference's."""
    _, tcfg, _, tp = model
    reqs = _paged_requests(plen)
    want = TS.ContinuousBatchingScheduler(
        tp, tcfg, prompt_len=plen, **SAMPLED).run(reqs).tokens_by_rid()
    _assert_tokens_equal(want, ref_runs[1][plen])
    lay = TLayout(4, (plen + 9) // 4 + 1, 40)
    sched = TS.ContinuousBatchingScheduler(
        tp, tcfg, paged=lay, prefill_chunk=chunk, prompt_len=plen,
        **SAMPLED)
    rep = sched.run(reqs)
    _assert_tokens_equal(rep.tokens_by_rid(), want)
    assert rep.ref_final.tolist() == [1] + [0] * 39
    # two shared-KV pools (k, v) per invocation, 2 invocations
    assert sched.kv_bytes_paged() == 40 * 4 * 4 * 32 * 2 * 2 * 2


def test_reset_slot_zeroes_one_slot(model):
    """The twin of tests/test_scheduler.py::test_reset_slot_zeroes_one_slot
    (SSM, conv and shared KV), and in a paged cache, where the pools and
    the slot's table row are kept."""
    _, tcfg, _, _ = model
    cache = tlm.init_cache(tcfg, 2, 8, device="cpu")
    for v in cache.values():
        v.add_(1)
    tlm.reset_slot(cache, 1)
    for k, v in cache.items():
        axis = 0 if k == "pos" else 1
        assert (v.select(axis, 0) == 1).all(), k
        assert (v.select(axis, 1) == 0).all(), k
    paged = tlm.init_paged_cache(tcfg, 2, 6, 4, 3, device="cpu")
    for v in paged.values():
        v.add_(1)
    tlm.reset_slot(paged, 1)
    for k in ("shared_k", "shared_v", "table"):
        assert (paged[k] == 1).all(), k
    for k in ("ssm", "conv_x", "conv_bc", "pos"):
        axis = 0 if k == "pos" else 1
        assert (paged[k].select(axis, 0) == 1).all(), k
        assert (paged[k].select(axis, 1) == 0).all(), k


def test_hybrid_scheduler_rules(model):
    """The reference's recurrent-family rules: no speculative rounds,
    paged prompts a whole number of prefill chunks, no prefix sharing."""
    _, tcfg, _, tp = model
    with pytest.raises(NotImplementedError, match="recurrent"):
        TS.ContinuousBatchingScheduler(tp, tcfg, slots=2, prompt_len=8,
                                       max_new_cap=4, draft_k=4)
    with pytest.raises(NotImplementedError, match="recurrent"):
        JS.ContinuousBatchingScheduler(model[2], model[0], slots=2,
                                       prompt_len=8, max_new_cap=4,
                                       draft_k=4)
    sched = TS.ContinuousBatchingScheduler(
        tp, tcfg, slots=2, prompt_len=16, max_new_cap=4,
        paged=TLayout(4, 6, 24), prefill_chunk=8)
    short = TS.Request(rid=0, prompt=np.arange(12, dtype=np.int32),
                       max_new_tokens=4)
    with pytest.raises(ValueError, match="multiple of prefill_chunk"):
        sched.run([short])
    rng = np.random.default_rng(2)
    head = rng.integers(0, 512, 8, dtype=np.int32)
    shared = [TS.Request(rid=i, prompt=np.concatenate(
        [head, rng.integers(0, 512, 8, dtype=np.int32)]), max_new_tokens=3)
        for i in range(4)]
    sched.run(shared)
    assert sched.last_prefix_plan.stats()["shared_blocks"] == 0


def test_speculative_paths_refuse_hybrid(model):
    _, tcfg, _, tp = model
    with pytest.raises(NotImplementedError, match="recurrent"):
        serve_speculative(ARCH, smoke=True, device="cpu", gen=4)
    cache = tlm.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="recurrent"):
        tlm.verify_step(tp, tcfg, torch.zeros((1, 3), dtype=torch.int64),
                        cache)
    with pytest.raises(NotImplementedError, match="recurrent"):
        TS.ContinuousBatchingScheduler(tp, tcfg, slots=1, prompt_len=8,
                                       max_new_cap=4, draft_k=2)


