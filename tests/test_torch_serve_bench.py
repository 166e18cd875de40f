"""The serve_bench twin (``repro_torch/launch/serve_bench.py``) end to end
on the CPU at small sizes: every section runs, its token assertions hold
inside it, its in-process gates hold (``run(gate=True)`` raises on a
failed gate), and its JSON document and Prometheus file are well formed.
The multi-tenant and telemetry sections run at the reference's sizes
(10 requests, context 128, prompts <= 64), where the paged pool's
footprint gate is defined; the other sections at a few tokens."""
import json
import re

import pytest
import torch

from repro_torch.launch import serve_bench as SB

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    prom = tmp_path_factory.mktemp("bench") / "metrics.prom"
    # 48 interleaved telemetry pairs: the gated on/off ratio is their
    # median, which a CPU shared with other processes still spreads by
    # +-4 % at 24 pairs
    out = SB.run(smoke=True, batch=2, prompt_len=8, gen=6, repeats=1,
                 draft_k=2, gate=True, device="cpu", sweep_bits=(None, 5),
                 telemetry_repeats=48, prom_path=str(prom))
    return out, prom


def test_sections_and_gates(result):
    r, _ = result
    assert r["gates"] == {"checked": True, "failed": []}
    assert r["packed_tokens_bit_identical"] and r["fused_tokens_bit_identical"]
    for mode in ("fp", "cim_packed", "cim_packed_unfused"):
        assert r["continuous_batching"][mode]["tokens_match_lockstep"]
    sl = r["speculative"]["serve_level"]
    assert sl["tokens_match_baseline"] and not sl["gated"]
    assert sl["reference_floor"] == SB.SPEC_SPEEDUP_FLOOR
    assert [p["tokens_match_lockstep"] for p in r["speculative"]["sweep"]] \
        == [True, True]
    # the 5-bit draft clips: verify rejects more of its drafts
    assert r["speculative"]["sweep"][1]["acceptance_rate"] < 1.0
    mt = r["multi_tenant"]
    assert mt["token_parity"] and mt["kv_reduction"] >= 2.0
    assert mt["paged"]["ttft_p50_s"] <= mt["paged"]["ttft_p95_s"]
    tel = r["telemetry"]
    assert tel["tokens_bit_identical"] and tel["ring_ttft_matches_instrumented"]
    assert tel["host_syncs_one_per_iteration"]
    assert tel["on_off_tok_s_ratio"] >= SB.OBS_OVERHEAD_FLOOR
    assert set(tel["fingerprints_metrics_off"]) == {"contiguous", "paged",
                                                    "speculative"}
    assert all(re.fullmatch("[0-9a-f]{64}", v)
               for v in tel["fingerprints_metrics_off"].values())
    assert tel["host"]["backend"] == "cpu"
    snap = tel["snapshot"]
    assert snap["counters"]["tokens"] == mt["paged"]["total_tokens"]
    assert snap["counters"]["prefix_blocks"] > 0


def test_json_document_and_prometheus_file(result):
    r, prom = result
    doc = json.loads(json.dumps(r, default=SB._json_default))
    assert doc["config"]["device"] == "cpu"
    text = prom.read_text()
    assert text.endswith("\n") and "# TYPE serve_tokens_total counter" in text
    sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$")
    assert all(sample.match(ln) for ln in text.splitlines()
               if not ln.startswith("#"))


def test_gate_check_reports_each_failure():
    """``check_gates`` on numbers that miss each gate names each one."""
    bad = SB.check_gates(dict(
        multi_tenant=dict(token_parity=False, paged_vs_contiguous_tok_s=0.7,
                          kv_reduction=3.0, paged=dict(stall_factor=5.0),
                          contiguous=dict(stall_factor=2.0)),
        telemetry=dict(on_off_tok_s_ratio=0.9)))
    assert len(bad) == 4
    assert SB.check_gates(dict(
        multi_tenant=dict(token_parity=True, paged_vs_contiguous_tok_s=0.85,
                          kv_reduction=2.5, paged=dict(stall_factor=2.0),
                          contiguous=dict(stall_factor=2.0)),
        telemetry=dict(on_off_tok_s_ratio=0.97))) == []
