"""Port parity: the continuous-batching scheduler (launch/scheduler.py)
against the reference's, on the minicpm-2b smoke model with packed CIM
weights taken from the reference ``lm.init`` through
``convert.params_from_jax``.

Greedy tokens must be equal, in contiguous mode and in paged mode with
chunked prefill and a shared prefix; so must the paged pool's peak block
count, and every refcount must drain back to the trash block's pin.  Each
reference scheduler runs once per module (a fixture): its compile
dominates the file's time.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import scheduler as JS
from repro.launch.paging import PagedLayout as JLayout
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.launch import scheduler as TS
from repro_torch.launch.paging import PagedLayout as TLayout
from repro_torch.launch.serve import serve_continuous
from repro_torch.models import lm as tlm

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

P, CAP, SLOTS = 16, 7, 2
BS, N_TBL, N_BLOCKS, CHUNK = 4, 6, 30, 8


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tcfg, "cpu")
    return (jlm.pack_cim_params(jp, jcfg), jcfg,
            tlm.pack_cim_params(tp, tcfg, "cpu"), tcfg)


def _mixed():
    return TS.mixed_length_requests(6, P, 512, stop_lengths=(3, CAP, 5),
                                    seed=1)


def _shared():
    """Half the requests share an 8-token prefix (two whole blocks)."""
    return TS.shared_prefix_requests(6, 8, 5, P, 512,
                                     stop_lengths=(3, CAP, 5), seed=2)


def _jreqs(reqs):
    return [JS.Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens,
                       stop_token=r.stop_token) for r in reqs]


@pytest.fixture(scope="module")
def contiguous(models):
    jp, jcfg, tp, tcfg = models
    kw = dict(slots=SLOTS, prompt_len=P, max_new_cap=CAP)
    want = JS.ContinuousBatchingScheduler(jp, jcfg, **kw).run(
        _jreqs(_mixed()))
    sched = TS.ContinuousBatchingScheduler(tp, tcfg, **kw)
    return want, sched, sched.run(_mixed())


@pytest.fixture(scope="module")
def paged(models):
    jp, jcfg, tp, tcfg = models
    kw = dict(slots=SLOTS, prompt_len=P, max_new_cap=CAP,
              prefill_chunk=CHUNK)
    want = JS.ContinuousBatchingScheduler(
        jp, jcfg, paged=JLayout(BS, N_TBL, N_BLOCKS), **kw).run(
        _jreqs(_shared()))
    sched = TS.ContinuousBatchingScheduler(
        tp, tcfg, paged=TLayout(BS, N_TBL, N_BLOCKS), **kw)
    return want, sched, sched.run(_shared())


def _assert_tokens_equal(got, want):
    got, want = got.tokens_by_rid(), want.tokens_by_rid()
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))


def test_contiguous_tokens_equal_reference_and_lockstep(contiguous):
    want, sched, got = contiguous
    _assert_tokens_equal(got, want)
    assert (got.n_steps, got.n_admits) == (int(want.n_steps),
                                           int(want.n_admits))
    _assert_tokens_equal(sched.run_lockstep(_mixed()), got)
    # one flags read per iteration, and the one that ends the loop
    assert got.host_syncs == got.n_iter + 1
    assert sum(got.branch_counts.values()) == got.n_iter


def test_paged_chunked_shared_equals_reference(paged):
    want, sched, got = paged
    _assert_tokens_equal(got, want)
    assert got.peak_blocks == want.peak_blocks > 0
    assert got.n_pf == want.n_pf > len(got.finished)   # chunked prefill ran
    assert sched.last_prefix_plan.stats()["shared_blocks"] > 0
    np.testing.assert_array_equal(got.ref_final,
                                  [1] + [0] * (N_BLOCKS - 1))


def test_paged_pool_equals_solo_and_contiguous(models, paged):
    _, _, tp, tcfg = models
    _, sched, got = paged
    for r in _shared()[:3]:
        solo = sched.run([r])
        np.testing.assert_array_equal(solo.tokens_by_rid()[r.rid],
                                      got.tokens_by_rid()[r.rid])
        np.testing.assert_array_equal(solo.ref_final,
                                      [1] + [0] * (N_BLOCKS - 1))
    unshared = TS.ContinuousBatchingScheduler(
        tp, tcfg, slots=3, prompt_len=P, max_new_cap=CAP,
        paged=TLayout(8, 3, 12), prefix_sharing=False).run(_shared())
    _assert_tokens_equal(unshared, got)


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_reset_slot_zeroes_one_slot_only(mode):
    cfg = tget("minicpm-2b", smoke=True)
    if mode == "paged":
        cache = tlm.init_paged_cache(cfg, 3, 10, 4, 5, device="cpu")
    else:
        cache = tlm.init_cache(cfg, 3, 12, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for k, v in cache.items():
        v.copy_(torch.randint(1, 9, v.shape, generator=gen).to(v.dtype))
    before = {k: v.clone() for k, v in cache.items()}
    out = tlm.reset_slot(cache, 1)
    assert out is cache
    for k, v in cache.items():
        if mode == "paged" and k in ("k", "v", "table"):
            assert torch.equal(v, before[k]), k     # shared / scheduler-owned
            continue
        ax = 0 if k in ("pos", "table") else 1
        assert not v.narrow(ax, 1, 1).any(), k
        for s in (0, 2):
            assert torch.equal(v.narrow(ax, s, 1),
                               before[k].narrow(ax, s, 1)), (k, s)


def test_serve_continuous_drivers():
    """serve_continuous asserts pool == lock-step (contiguous) and paged
    == contiguous itself; here both run at the smoke size on the CPU."""
    toks, stats = serve_continuous("minicpm-2b", smoke=True, slots=2,
                                   prompt_len=8, n_requests=4, cim=True,
                                   stop_lengths=(2, 5), device="cpu")
    assert stats["tokens_match_lockstep"] and sorted(toks) == [0, 1, 2, 3]
    assert stats["host_syncs"] == stats["n_iter"] + 1
    lay = TLayout(block_size=4, n_tbl=4, n_blocks=12)
    ptoks, pstats = serve_continuous("minicpm-2b", smoke=True, slots=2,
                                     prompt_len=8, n_requests=4, cim=True,
                                     stop_lengths=(2, 5), device="cpu",
                                     paged=lay, prefill_chunk=4)
    assert pstats["tokens_match_contiguous"]
    assert pstats["paged"]["refcounts_drained"]
    for rid in toks:
        np.testing.assert_array_equal(ptoks[rid], toks[rid])


@pytest.mark.parametrize("kw", [dict(family="ssm", draft_k=4),
                                dict(family="vlm"),
                                dict(family="hybrid", draft_k=4)])
def test_unported_options_raise(kw):
    """Options the port does not serve raise, as the reference's
    scheduler does: the vlm family (no per-request frontends), and
    speculative rounds over the ssm and hybrid families (their recurrent
    state cannot roll back a draft block).  Speculative rounds on the dense family are served
    (tests/test_torch_spec_scheduler.py), and so are the moe, ssm and
    hybrid families (tests/test_torch_moe_serve.py, tests/test_torch_ssm.py,
    tests/test_torch_hybrid_scheduler.py),
    sampling (tests/test_torch_sampling.py) and telemetry, ``obs``
    (tests/test_torch_obs.py)."""
    kw = dict(kw)
    cfg = dataclasses.replace(tget("minicpm-2b", smoke=True),
                              family=kw.pop("family", "dense"))
    with pytest.raises(NotImplementedError):
        TS.ContinuousBatchingScheduler({"x": torch.zeros(1)}, cfg, slots=2,
                                       prompt_len=4, max_new_cap=4, **kw)
