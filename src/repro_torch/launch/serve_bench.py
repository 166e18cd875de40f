"""Serving benchmark twin: the port's run of ``benchmarks/serve_bench.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve_bench --smoke \
      [--gate] [--prom-out PATH] [--device cpu]

Counterpart of the reference's serving benchmark, section for section, on
the port (CUDA by default; ``--device cpu`` runs the plain version):

  decode        lock-step ``serve``: fp, CIM unpacked (the raw-weight
                GEMM, kernel row 6 on the card), CIM packed unfused and
                packed + fused (rows 1 and 2), each the median of
                ``repeats`` runs; unpacked, unfused and packed tokens are
                asserted equal;
  continuous    ``serve_continuous`` against its lock-step wave baseline
                on the same pool (fp, packed, packed unfused), tokens
                asserted equal inside ``serve_continuous``;
  speculative   the serve-level speculative driver against ``serve``
                (greedy tokens asserted equal), and the acceptance sweep
                over the draft plan's SAR width through the scheduler;
  multi_tenant  ``scheduler.multi_tenant_trace`` with its Poisson
                arrivals: the contiguous pool (prompts padded to the
                context limit) against the paged pool with chunked
                prefill and shared prefixes, whose tokens must equal the
                paged pool's without sharing; throughput from ``run``,
                TTFT and the stall factor from one more run (on
                the card the smoke model's heads are regrouped into the
                paged kernel's 64-wide ones, ``paged_config``);
  telemetry     the same trace through one paged scheduler with metrics
                off and one with them on, interleaved repeats after one
                warm run each: tokens equal, the ring TTFT equal to
                ``run_instrumented``'s ``first_iter`` request by request,
                the on/off tok/s ratio, the metrics-off op-sequence
                fingerprints (``obs.fingerprint.fingerprint_variants``)
                and the host fingerprint.

It prints one JSON document (and writes the metrics-on run's Prometheus
exposition only where ``--prom-out`` is given); it reads and writes no
committed baseline.  ``--gate`` checks the gates that run inside the
process: the multi-tenant token parity, the paged pool's throughput-or-
footprint gate (>= 1.3x tok/s, or >= 2x less peak KV at >= 0.8x tok/s),
its stall factor within 1.25x the contiguous pool's, and the telemetry
floor (metrics-on >= 0.95x metrics-off tok/s).  The two throughput
ratios are medians over interleaved pairs of runs (each pair's two runs
see the same load; the reference gates on the ratio of best-of-N rates,
whose two sides a shared host moves apart at random).  The gated
sections time their runs on the scheduler's wall clock on the card and
on the calling thread's CPU time on the CPU (``_cpu_clock``), where a
host shared with other processes stretches wall times.  The reference's
speculative floor (serve-level speedup >= 1.5x) is reported beside the
measured speedup and not gated: it measures the per-dispatch cost of
XLA's executables that one compiled round amortizes over its tokens,
and the port's lock-step decode dispatches no more per token than a
round does (one graph replay a step on the card, the same eager ops on
the CPU).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import statistics
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..models import lm
from ..obs import REGISTRY, ObsConfig, host_fingerprint
from ..obs.fingerprint import fingerprint_variants
from .paging import PagedLayout, cdiv
from .scheduler import (ContinuousBatchingScheduler, Request,
                        multi_tenant_trace)
from .serve import serve, serve_continuous, serve_speculative

# the reference's in-process gates (benchmarks/serve_bench.py)
SPEC_SPEEDUP_FLOOR = 1.5          # reported, not gated (module docstring)
PAGED_TOK_S_FLOOR = 1.3
PAGED_KV_REDUCTION_FLOOR = 2.0
PAGED_ISO_TOK_S = 0.8
STALL_RATIO_SLACK = 1.25
OBS_OVERHEAD_FLOOR = 0.95


def decode_rows(arch: str, smoke: bool, batch: int, prompt_len: int,
                gen: int, repeats: int, device) -> dict:
    """Median-of-repeats lock-step decode rates of fp, CIM unpacked,
    packed unfused and packed serving; greedy tokens asserted
    deterministic and equal across the CIM variants."""
    def measure(cim: bool, pack: bool, fuse: bool = True):
        runs = [serve(arch, smoke=smoke, batch=batch, prompt_len=prompt_len,
                      gen=gen, cim=cim, pack=pack, fuse=fuse,
                      return_stats=True, device=device)
                for _ in range(repeats)]
        toks = runs[0][0]
        for t, _ in runs[1:]:
            assert (t == toks).all(), "greedy serving must be deterministic"
        rates = sorted(s["decode_tok_s"] for _, s in runs)
        best = max((s for _, s in runs), key=lambda s: s["decode_tok_s"])
        row = {k: best[k] for k in ("pack_s", "prefill_s", "decode_s",
                                    "decode_tok_s", "pack_bytes", "graphs")}
        row.update(decode_tok_s_median=statistics.median(rates),
                   decode_tok_s_runs=rates)
        return toks, row

    _, fp = measure(cim=False, pack=False)
    tok_u, unpacked = measure(cim=True, pack=False, fuse=False)
    tok_nf, unfused = measure(cim=True, pack=True, fuse=False)
    tok_p, packed = measure(cim=True, pack=True)
    assert (tok_u == tok_p).all(), \
        "packed + fused CIM serving diverged from the unpacked unfused path"
    assert (tok_nf == tok_p).all(), \
        "fused serving changed tokens vs the unfused packed path"
    med = lambda r: r["decode_tok_s_median"]
    return dict(fp=fp, cim_unpacked=unpacked, cim_packed_unfused=unfused,
                cim_packed=packed, packed_tokens_bit_identical=True,
                fused_tokens_bit_identical=True,
                decode_speedup_packed_vs_unpacked=med(unfused) / med(unpacked),
                decode_speedup_fusion=med(packed) / med(unfused),
                decode_speedup_vs_unpacked=med(packed) / med(unpacked))


def continuous_rows(arch: str, smoke: bool, batch: int, prompt_len: int,
                    repeats: int, device) -> dict:
    """Continuous batching against the lock-step waves on a mixed-length
    queue (4 x batch requests), fp, packed and packed unfused; tokens
    asserted equal inside ``serve_continuous``."""
    cb, toks = {}, {}
    for mode, cim, fuse in (("fp", False, True), ("cim_packed", True, True),
                            ("cim_packed_unfused", True, False)):
        toks[mode], st = serve_continuous(
            arch, smoke=smoke, slots=batch, prompt_len=prompt_len,
            n_requests=4 * batch, stop_lengths=(4, 16, 8, 12), cim=cim,
            fuse=fuse, repeats=repeats, device=device)
        cb[mode] = dict(continuous=st["continuous"], lockstep=st["lockstep"],
                        tok_s_median=st["tok_s_median"],
                        lockstep_tok_s_median=st["lockstep_tok_s_median"],
                        tokens_match_lockstep=st["tokens_match_lockstep"],
                        speedup_vs_lockstep=st["speedup_vs_lockstep"])
    for rid, want in toks["cim_packed"].items():
        np.testing.assert_array_equal(
            toks["cim_packed_unfused"][rid], want,
            err_msg=f"request {rid}: fusion changed continuous-batching "
                    "tokens")
    cb["fusion_speedup"] = (cb["cim_packed"]["tok_s_median"]
                            / cb["cim_packed_unfused"]["tok_s_median"])
    cb["fused_tokens_bit_identical"] = True
    return cb


def speculative_rows(arch: str, smoke: bool, batch: int, prompt_len: int,
                     gen: int, draft_k: int, repeats: int, nonspec_tok_s,
                     device, sweep_bits=(None, 7, 6, 5)) -> dict:
    """The serve-level speculative driver against ``serve`` (medians of
    ``repeats``; greedy tokens asserted equal inside
    ``serve_speculative``), and the
    acceptance sweep over the draft SAR width through the scheduler."""
    runs = [serve_speculative(arch, smoke=smoke, batch=batch,
                              prompt_len=prompt_len, gen=gen,
                              draft_k=draft_k, return_stats=True,
                              device=device)[1]
            for _ in range(repeats)]
    spec_med = statistics.median(s["decode_tok_s"] for s in runs)
    base_med = statistics.median(s["baseline_decode_tok_s"] for s in runs)
    keep = ("draft_plan", "n_rounds", "n_drafted", "n_accepted",
            "acceptance_rate", "tokens_per_round", "tokens_match_baseline")
    serve_level = dict({k: runs[0][k] for k in keep},
                       decode_tok_s_median=spec_med,
                       baseline_decode_tok_s_median=base_med,
                       decode_speedup_speculative=spec_med / base_med,
                       reference_floor=SPEC_SPEEDUP_FLOOR, gated=False)
    sweep = []
    for bits in sweep_bits:
        _, st = serve_continuous(
            arch, smoke=smoke, slots=batch, prompt_len=prompt_len,
            n_requests=4 * batch, stop_lengths=(4, 16, 8, 12), cim=True,
            draft_k=draft_k, draft_adc_bits=bits, repeats=repeats,
            device=device)
        cont = st["continuous"]
        sweep.append(dict(
            draft_plan=st["draft_plan"], draft_k=draft_k,
            acceptance_rate=cont["acceptance_rate"],
            tokens_per_step=cont["tokens_per_step"],
            tok_s_median=st["tok_s_median"],
            speedup_vs_nonspec_cb=st["tok_s_median"] / nonspec_tok_s,
            tokens_match_lockstep=st["tokens_match_lockstep"]))
    return dict(serve_level=serve_level, sweep=sweep)


def paged_config(arch: str, smoke: bool, device):
    """The model config of the multi-tenant sections: the arch's, with
    its heads regrouped into 64-wide ones on a CUDA device where they are
    narrower (the paged-attention kernel, row 3, takes head dims 64 and
    128; the smoke config's are 32): the same d_model, projections and
    depth."""
    cfg = get_config(arch, smoke=smoke)
    if torch.device(device).type == "cuda" and cfg.d_head < 64:
        f = 64 // cfg.d_head
        cfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // f,
                                  n_kv_heads=cfg.n_kv_heads // f, d_head=64)
    return cfg


def _trace_pools(arch: str, smoke: bool, slots: int, prompt_len: int,
                 max_prompt: int, n_requests: int, block_size: int,
                 seed: int, device):
    """The multi-tenant sections' shared set-up: fp params, the trace and
    its arrivals, the paged layout and the scheduler keywords."""
    cfg = paged_config(arch, smoke, device)
    with torch.inference_mode():
        params = lm.init(seed, cfg, device=device)
    cap = 12
    reqs, arrivals = multi_tenant_trace(n_requests, max_prompt,
                                        cfg.vocab_size, block_size,
                                        seed=seed)
    lay = PagedLayout(block_size=block_size,
                      n_tbl=cdiv(prompt_len + cap, block_size),
                      n_blocks=2 * slots * cdiv(max_prompt + cap,
                                                block_size) + 8)
    kw = dict(slots=slots, prompt_len=prompt_len, max_new_cap=cap,
              seed=seed)
    return cfg, params, reqs, arrivals, lay, kw


def _cpu_clock():
    """The clock of the gated sections' runs on the CPU: the calling
    thread's CPU time (the whole process's when torch runs more than one
    thread), which a host shared with other processes does not stretch
    as it stretches wall time."""
    return (time.thread_time if torch.get_num_threads() == 1
            else time.process_time)


def _rate(run, device) -> tuple:
    """One scheduler run ``run()`` -> (its report, its tok/s): the
    report's own on the card (wall clock), per second of ``_cpu_clock``
    on the CPU."""
    if torch.device(device).type == "cuda":
        rep = run()
        return rep, rep.tok_s
    clock = _cpu_clock()
    t0 = clock()
    rep = run()
    return rep, rep.total_tokens / max(clock() - t0, 1e-9)


def _timeline(sched, reqs, arrivals, device) -> tuple:
    """(report, timeline) of one run for the stall factor: on the card
    the scheduler's own (``run_instrumented``: wall time between the
    host's flags reads); on the CPU each iteration's branch code and its
    seconds of ``_cpu_clock`` from the branch's start to its end, marked
    through ``run``'s ``on_branch``."""
    if torch.device(device).type == "cuda":
        return sched.run_instrumented(reqs, arrivals)
    clock, marks = _cpu_clock(), []
    rep = sched.run(reqs, arrivals,
                    on_branch=lambda b: marks.append((b, clock())))
    starts, ends = marks[0::2], marks[1::2]
    return rep, dict(
        branch=np.array([sched._branch_code[b] for b, _ in starts]),
        iter_s=np.array([e - s for (_, s), (_, e) in zip(starts, ends)]))


@contextlib.contextmanager
def _no_gc():
    """Timed runs without Python's garbage collector (collected first):
    its pauses land on either side of a comparison at random."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _stall(timeline, step_branch: int) -> float:
    """Worst-iteration (p95) over median decode-step duration: how long
    the slowest iterations (long-prompt admits, in the contiguous pool)
    starve every live decoder."""
    it = timeline["iter_s"]
    steps = it[timeline["branch"] == step_branch]
    med = float(np.median(steps)) if steps.size else float("nan")
    p95 = float(np.percentile(it, 95))
    return p95 / med if med and med > 0 else float("nan")


def run_multi_tenant(arch: str = "minicpm-2b", smoke: bool = True,
                     slots: int = 3, prompt_len: int = 128,
                     max_prompt: int = 64, n_requests: int = 10,
                     block_size: int = 8, prefill_chunk: int = 16,
                     repeats: int = 3, seed: int = 0, device=None) -> dict:
    """Paged against contiguous KV on the multi-tenant trace: the
    contiguous pool (prompts padded to the context limit, all it can do
    with mixed lengths), the paged pool single-shot without sharing (the
    parity reference) and the paged pool with chunked prefill and
    shared prefixes (the candidate), all under the trace's arrivals."""
    cfg, params, reqs, arrivals, lay, kw = _trace_pools(
        arch, smoke, slots, prompt_len, max_prompt, n_requests, block_size,
        seed, device)
    padded = [Request(rid=r.rid,
                      prompt=np.concatenate(
                          [r.prompt, np.zeros(prompt_len - len(r.prompt),
                                              np.int32)]),
                      max_new_tokens=r.max_new_tokens,
                      stop_token=r.stop_token) for r in reqs]
    contig = ContinuousBatchingScheduler(params, cfg, **kw)
    paged = ContinuousBatchingScheduler(
        params, cfg, paged=lay, prefill_chunk=prefill_chunk,
        prefix_sharing=True, **kw)
    paged_ref = ContinuousBatchingScheduler(
        params, cfg, paged=lay, prefix_sharing=False, **kw)
    want = paged_ref.run(reqs).tokens_by_rid()
    got = paged.run(reqs).tokens_by_rid()
    for rid in want:
        np.testing.assert_array_equal(
            got[rid], want[rid],
            err_msg=f"request {rid}: chunked/shared paged prefill changed "
                    "tokens vs single-shot paged")
    with _no_gc():
        pairs = [(_rate(lambda: paged.run(reqs, arrivals), device),
                  _rate(lambda: contig.run(padded, arrivals), device))
                 for _ in range(repeats)]
    pg_runs = [pg[0] for pg, _ in pairs]
    pg_tok = statistics.median(pg[1] for pg, _ in pairs)
    ct_tok = statistics.median(ct[1] for _, ct in pairs)
    ratio = statistics.median(pg[1] / ct[1] for pg, ct in pairs)
    pg_rep, pg_tl = _timeline(paged, reqs, arrivals, device)
    ct_rep, ct_tl = _timeline(contig, padded, arrivals, device)
    peak = max(r.peak_blocks for r in pg_runs + [pg_rep])
    kv_paged = paged.kv_bytes_paged(peak)
    kv_contig = contig.kv_bytes_contiguous()
    return dict(
        config=dict(arch=arch, slots=slots, prompt_len=prompt_len,
                    max_prompt=max_prompt, n_requests=n_requests,
                    block_size=block_size, n_blocks=lay.n_blocks,
                    prefill_chunk=prefill_chunk, repeats=repeats),
        token_parity=True,
        paged=dict(pg_rep.summary(), tok_s_median=pg_tok,
                   **pg_rep.ttft_percentiles(),
                   stall_factor=_stall(pg_tl, 3)),
        contiguous=dict(ct_rep.summary(), tok_s_median=ct_tok,
                        **ct_rep.ttft_percentiles(),
                        stall_factor=_stall(ct_tl, 2)),
        paged_vs_contiguous_tok_s=ratio,
        kv_bytes_paged_peak=kv_paged, kv_bytes_contiguous=kv_contig,
        kv_reduction=kv_contig / kv_paged if kv_paged else float("nan"))


def run_telemetry(arch: str = "minicpm-2b", smoke: bool = True,
                  slots: int = 3, prompt_len: int = 128,
                  max_prompt: int = 64, n_requests: int = 10,
                  block_size: int = 8, prefill_chunk: int = 16,
                  repeats: int = 8, seed: int = 0, device=None,
                  prom_path: Optional[str] = None) -> dict:
    """Metrics off and on through the same paged scheduler set-up on the
    multi-tenant trace: one warm run each (graph capture off the clock),
    then ``repeats`` interleaved timed runs; tokens equal on every run,
    the ring TTFT equal to ``run_instrumented``'s ``first_iter``, the
    on/off tok/s ratio (the median of the repeats' pairs' ratios; the
    best rates reported beside it), and the metrics-off
    fingerprints of the three loop variants."""
    cfg, params, reqs, arrivals, lay, kw = _trace_pools(
        arch, smoke, slots, prompt_len, max_prompt, n_requests, block_size,
        seed, device)
    kw.update(paged=lay, prefill_chunk=prefill_chunk, prefix_sharing=True)
    off = ContinuousBatchingScheduler(params, cfg, **kw)
    on = ContinuousBatchingScheduler(params, cfg, obs=ObsConfig(), **kw)

    def variant(name):
        if name == "paged":
            return ContinuousBatchingScheduler(params, cfg, **kw)
        kw2 = dict(slots=2, prompt_len=16, max_new_cap=4, seed=seed)
        if name == "speculative":
            kw2["draft_k"] = 2
        return ContinuousBatchingScheduler(params, cfg, **kw2)
    fps = fingerprint_variants(variant, 2)

    off_runs = [off.run(reqs, arrivals)]
    on_runs = [on.run(reqs, arrivals)]
    rates = {"off": [], "on": []}
    with _no_gc():
        for _ in range(repeats):
            for name, sched, runs in (("off", off, off_runs),
                                      ("on", on, on_runs)):
                rep, rate = _rate(lambda: sched.run(reqs, arrivals), device)
                runs.append(rep)
                rates[name].append(rate)
    want = off_runs[0].tokens_by_rid()
    for r in off_runs[1:] + on_runs:
        got = r.tokens_by_rid()
        for rid in want:
            np.testing.assert_array_equal(
                got[rid], want[rid],
                err_msg=f"request {rid}: telemetry rings changed tokens")
    syncs_ok = all(r.host_syncs == r.n_iter + 1 for r in off_runs + on_runs)
    assert syncs_ok, "a loop read the device more than once an iteration"
    off_best, on_best = max(rates["off"]), max(rates["on"])
    ri, _ = on.run_instrumented(reqs, arrivals)
    ring_ttft = on_runs[0].obs.ttft_iters
    inst_ttft = {f.rid: f.first_iter for f in ri.finished}
    assert ring_ttft == inst_ttft, \
        f"ring TTFT diverged from instrumented: {ring_ttft} vs {inst_ttft}"
    snap = on_runs[1 + int(np.argmax(rates["on"]))].obs
    snap.register(REGISTRY)
    if prom_path:
        with open(prom_path, "w") as f:
            f.write(REGISTRY.export_prometheus())
    return dict(
        fingerprints_metrics_off=fps, host=host_fingerprint(device),
        tok_s_off_median=statistics.median(rates["off"]),
        tok_s_on_median=statistics.median(rates["on"]),
        tok_s_off_best=off_best, tok_s_on_best=on_best,
        on_off_tok_s_ratio=statistics.median(
            on / off for on, off in zip(rates["on"], rates["off"])),
        tokens_bit_identical=True, host_syncs_one_per_iteration=syncs_ok,
        ring_ttft_matches_instrumented=True, snapshot=snap.to_dict(),
        prom_path=prom_path)


def check_gates(result: dict) -> list:
    """The in-process gates (module docstring): a list of failures."""
    bad = []
    mt = result.get("multi_tenant")
    if mt is not None:
        if not mt["token_parity"]:
            bad.append("multi-tenant paged token parity failed")
        r_tok, r_kv = mt["paged_vs_contiguous_tok_s"], mt["kv_reduction"]
        if not (r_tok >= PAGED_TOK_S_FLOOR
                or (r_kv >= PAGED_KV_REDUCTION_FLOOR
                    and r_tok >= PAGED_ISO_TOK_S)):
            bad.append(f"paged KV pool misses its gate: {r_tok:.2f}x tok/s, "
                       f"{r_kv:.2f}x KV reduction")
        s_pg = mt["paged"]["stall_factor"]
        s_ct = mt["contiguous"]["stall_factor"]
        if not s_pg <= STALL_RATIO_SLACK * s_ct:
            bad.append(f"paged stall factor {s_pg:.2f} > "
                       f"{STALL_RATIO_SLACK}x contiguous {s_ct:.2f}")
    tel = result.get("telemetry")
    if tel is not None and not tel["on_off_tok_s_ratio"] >= \
            OBS_OVERHEAD_FLOOR:
        bad.append(f"telemetry overhead: metrics-on is "
                   f"{tel['on_off_tok_s_ratio']:.3f}x metrics-off "
                   f"(floor {OBS_OVERHEAD_FLOOR}x)")
    return bad


def run(arch: str = "minicpm-2b", smoke: bool = True, batch: int = 2,
        prompt_len: int = 16, gen: int = 48, repeats: int = 3,
        draft_k: int = 8, gate: bool = False, multi_tenant: bool = True,
        device=None, mt_requests: int = 10, mt_prompt_len: int = 128,
        mt_max_prompt: int = 64, telemetry_repeats: int = 8,
        sweep_bits=(None, 7, 6, 5), prom_path: Optional[str] = None
        ) -> dict:
    """Every section (module docstring); with ``gate``, raises
    SystemExit listing the failed gates (the result is in
    ``result["gates"]`` either way)."""
    dev = resolve_device(device)
    result = dict(config=dict(arch=arch, smoke=smoke, batch=batch,
                              prompt_len=prompt_len, gen=gen,
                              repeats=repeats, draft_k=draft_k,
                              device=str(dev)))
    result.update(decode_rows(arch, smoke, batch, prompt_len, gen, repeats,
                              dev))
    cb = continuous_rows(arch, smoke, batch, prompt_len, max(repeats, 3),
                         dev)
    result["continuous_batching"] = cb
    result["speculative"] = speculative_rows(
        arch, smoke, batch, prompt_len, gen, draft_k, repeats,
        cb["cim_packed"]["tok_s_median"], dev, sweep_bits)
    mt_kw = dict(smoke=smoke, prompt_len=mt_prompt_len,
                 max_prompt=mt_max_prompt, n_requests=mt_requests,
                 device=dev)
    if multi_tenant:
        result["multi_tenant"] = run_multi_tenant(
            arch, repeats=max(repeats, 3), **mt_kw)
    result["telemetry"] = run_telemetry(
        arch, repeats=max(repeats, telemetry_repeats), prom_path=prom_path,
        **mt_kw)
    bad = check_gates(result)
    result["gates"] = dict(checked=gate, failed=bad)
    if gate and bad:
        print(json.dumps(result, default=_json_default))
        raise SystemExit("serve_bench gates failed: " + "; ".join(bad))
    return result


def _json_default(v):
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    return str(v)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (the reference's size)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--draft-k", type=int, default=8)
    ap.add_argument("--gate", action="store_true",
                    help="exit non-zero unless the in-process gates hold")
    ap.add_argument("--multi-tenant", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the paged-vs-contiguous multi-tenant section")
    ap.add_argument("--prom-out", default=None,
                    help="write the metrics-on run's Prometheus exposition")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    result = run(args.arch, args.smoke, args.batch, args.prompt_len,
                 args.gen, args.repeats, args.draft_k, gate=args.gate,
                 multi_tenant=args.multi_tenant, device=args.device,
                 prom_path=args.prom_out)
    print(json.dumps(result, default=_json_default))


if __name__ == "__main__":
    main()
