"""Port parity: open-loop arrivals (``run(requests, arrival_iters)``) and
``run_instrumented`` against the reference's scheduler, on the
multi-tenant trace, with the minicpm-2b smoke model and packed CIM
weights taken from the reference ``lm.init`` through
``convert.params_from_jax``.

The trace's generator equals the reference's draw for draw; served with
its Poisson arrivals, a contiguous pool (prompts padded to the context
limit) and a paged pool (chunked prefill, shared prefixes) give the
reference's tokens, ``first_iter`` and ``finish_iter`` for every request,
its step/admit/prefill counts, and an instrumented timeline whose branch
per iteration equals the reference's.  Every comparison is ``==``.  Each
reference scheduler is built once per module (a fixture).
"""
import dataclasses
import sys
from pathlib import Path

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
from repro_torch.models import lm as tlm

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import serve_bench as ref_bench  # noqa: E402

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

N_REQ, MAX_PROMPT, BS, VOCAB = 6, 20, 4, 512
P, CAP, SLOTS, CHUNK = 32, 12, 2, 8
N_TBL, N_BLOCKS = 11, 40


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


def _trace():
    return TS.multi_tenant_trace(N_REQ, MAX_PROMPT, VOCAB, BS, seed=3)


def _padded(reqs):
    return [TS.Request(rid=r.rid,
                       prompt=np.concatenate(
                           [r.prompt, np.zeros(P - len(r.prompt), np.int32)]),
                       max_new_tokens=r.max_new_tokens) for r in reqs]


def _jreqs(reqs):
    return [JS.Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens,
                       stop_token=r.stop_token) for r in reqs]


def _kw(layout):
    kw = dict(slots=SLOTS, prompt_len=P, max_new_cap=CAP)
    if layout == "paged":
        kw.update(prefill_chunk=CHUNK)
    return kw


@pytest.fixture(scope="module")
def reference(models):
    """Per layout: the reference scheduler's run and instrumented run
    of the trace under its arrivals, and its run with every request due
    at iteration 5."""
    jp, jcfg, _, _ = models
    reqs, arrivals = _trace()
    out = {}
    for layout in ("contiguous", "paged"):
        extra = ({"paged": JLayout(BS, N_TBL, N_BLOCKS)}
                 if layout == "paged" else {})
        sched = JS.ContinuousBatchingScheduler(jp, jcfg, **_kw(layout),
                                               **extra)
        rq = _jreqs(reqs if layout == "paged" else _padded(reqs))
        out[layout] = dict(run=sched.run(rq, arrivals),
                           inst=sched.run_instrumented(rq, arrivals),
                           late=sched.run(rq, [5] * len(rq)))
    return out


def _port(models, layout):
    _, _, tp, tcfg = models
    extra = ({"paged": TLayout(BS, N_TBL, N_BLOCKS)}
             if layout == "paged" else {})
    return TS.ContinuousBatchingScheduler(tp, tcfg, **_kw(layout), **extra)


def _assert_same(got, want):
    g = {f.rid: f for f in got.finished}
    w = {f.rid: f for f in want.finished}
    assert sorted(g) == sorted(w)
    for rid in w:
        np.testing.assert_array_equal(g[rid].tokens, w[rid].tokens,
                                      err_msg=str(rid))
        assert (g[rid].first_iter, g[rid].finish_iter) == (
            w[rid].first_iter, w[rid].finish_iter), rid
    assert (got.n_steps, got.n_admits, got.n_pf, got.peak_blocks) == (
        want.n_steps, want.n_admits, want.n_pf, want.peak_blocks)


def test_trace_equals_reference_generator():
    reqs, arrivals = _trace()
    jreqs, jarr = ref_bench.multi_tenant_trace(N_REQ, MAX_PROMPT, VOCAB, BS,
                                               seed=3)
    assert arrivals == jarr
    assert any(a > 0 for a in arrivals)
    for r, j in zip(reqs, jreqs):
        assert (r.rid, r.max_new_tokens) == (j.rid, j.max_new_tokens)
        np.testing.assert_array_equal(r.prompt, j.prompt)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_arrivals_equal_reference(models, reference, layout):
    reqs, arrivals = _trace()
    rq = reqs if layout == "paged" else _padded(reqs)
    sched = _port(models, layout)
    got = sched.run(rq, arrivals)
    _assert_same(got, reference[layout]["run"])
    # the instrumented run: the same program, its timeline the reference's
    ri, tl = sched.run_instrumented(rq, arrivals)
    jri, jtl = reference[layout]["inst"]
    _assert_same(ri, jri)
    np.testing.assert_array_equal(tl["branch"], jtl["branch"])
    assert got.n_iter == ri.n_iter == len(jtl["branch"])
    assert got.host_syncs == got.n_iter + 1
    # no request is admitted before it arrives
    for f, a in zip(sorted(got.finished, key=lambda f: f.rid), arrivals):
        assert a <= f.first_iter <= f.finish_iter
    p = ri.ttft_percentiles()
    assert 0 < p["ttft_p50_s"] <= p["ttft_p95_s"] <= ri.wall_s


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_late_arrivals_step_the_idle_pool(models, reference, layout):
    """Every request due at iteration 5: the empty pool steps until then,
    as the reference's does (the iteration stamps equal its)."""
    reqs, _ = _trace()
    rq = reqs if layout == "paged" else _padded(reqs)
    got = _port(models, layout).run(rq, [5] * len(rq))
    _assert_same(got, reference[layout]["late"])
    assert min(f.first_iter for f in got.finished) >= 5
    assert got.branch_counts["step"] >= 5


def test_default_arrivals_and_length_mismatch(models):
    reqs, _ = _trace()
    rq = _padded(reqs)
    sched = _port(models, "contiguous")
    a, b = sched.run(rq), sched.run(rq, [0] * len(rq))
    for rid, toks in a.tokens_by_rid().items():
        np.testing.assert_array_equal(b.tokens_by_rid()[rid], toks)
    assert [f.first_iter for f in a.finished] == [
        f.first_iter for f in b.finished]
    with pytest.raises(ValueError, match="arrival_iters"):
        sched.run(rq, [0] * (len(rq) - 1))
