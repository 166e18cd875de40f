"""The resilience bench twin (``repro_torch/launch/resilience_bench.py``)
and ``serve_guarded`` on the CPU at the reference bench's sizes (the
minicpm-2b smoke model, 4 requests of 8 prompt tokens, segments of 4
iterations), on the reference's weights through
``convert.params_from_jax``: the twin's five sections hold their gates,
its RMS section equals the reference bench's numbers at rtol 1e-4 (the
float32 norm sums run in another order, ROADMAP Queue 3 item 5), its
JSON goes only where it is told, a breached gate exits, and
``serve_guarded``'s tokens and resilience log equal the reference's."""
import copy
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch.serve import serve_guarded as j_serve_guarded
from repro.models import lm as jlm
from repro.resilience.faults import FaultModel as JFault
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.launch import resilience_bench as RB
from repro_torch.launch.serve import serve_guarded
from repro_torch.models import lm as tlm
from repro_torch.resilience.faults import FaultModel

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks.resilience_bench import run_rms as j_run_rms  # noqa: E402

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

_DRIFT_SPEC = ("seed=3,gain_amp=0.6,offset_lsb=2.0,schedule=ramp,onset=4,"
               "period=16")


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tcfg, "cpu")
    return jp, jcfg, tp, tcfg


@pytest.fixture(scope="module")
def result(weights, tmp_path_factory):
    _, _, tp, _ = weights
    path = tmp_path_factory.mktemp("bench") / "resilience.json"
    return RB.run(repeats=1, device="cpu", params=tp, path=str(path)), path


def test_five_sections_hold_their_gates(result):
    r, _ = result
    fp = r["fingerprints"]
    assert fp["identical_after_arm_cycle"] and fp["fault_segment_differs"]
    assert set(fp["plain_loop"]) == {"contiguous", "paged", "speculative"}
    assert fp["segment_fault_on"] != fp["segment_fault_off"]
    cg = r["clean_guarded"]
    assert cg["state"] == "GREEN" and cg["n_actions"] == 0
    assert cg["token_parity"] and cg["n_compiles"] == 3
    det = r["detection"]
    assert det["state"] == "RED" and det["final_rung"] == "digital"
    assert det["detection_tokens"] <= det["budget_tokens"] == 32
    assert det["n_compiles"] == 3 and det["n_actions"] >= 1
    rms = r["rms"]
    assert rms["rms_drift_failover"] <= 2.0 * rms["rms_clean"]
    assert rms["rms_drift_no_failover"] > rms["rms_drift_failover"]
    assert [row["label"] for row in r["ladder"]] == ["analog", "hybrid",
                                                     "digital"]
    assert all(row["tok_s_median"] > 0 for row in r["ladder"])
    assert r["config"]["device"] == "cpu"


def test_rms_section_equals_reference(weights, result):
    """The reference bench's ``run_rms`` on the same weights: the three
    RMS values at rtol 1e-4."""
    jp, jcfg, _, _ = weights
    r, _ = result
    want = j_run_rms(jp, jlm.pack_cim_params(jp, jcfg), jcfg,
                     JFault(**RB._DRIFT))
    for k in ("rms_clean", "rms_drift_no_failover", "rms_drift_failover"):
        np.testing.assert_allclose(r["rms"][k], want[k], rtol=1e-4)


def test_json_written_where_told(result):
    r, path = result
    doc = json.loads(path.read_text())
    assert doc["detection"]["resilience"] == json.loads(
        json.dumps(r["detection"]["resilience"]))


def test_a_breached_gate_exits(weights):
    """A model that never touches the epilogue cannot reach RED: the
    detection gate exits, as the reference's does."""
    _, _, tp, tcfg = weights
    packed = tlm.pack_cim_params(tp, tcfg, "cpu")
    with pytest.raises(SystemExit):
        RB.run_detection(packed, tcfg, FaultModel(seed=3, stuck_frac=0.1),
                         prompt_len=8, n_requests=2, seed=0, segment_iters=4)


def _log_equal(got, want):
    """Resilience logs equal, the probe ratios at rtol 1e-4."""
    got, want = copy.deepcopy(got), copy.deepcopy(want)
    gw, ww = got.pop("watchdog"), want.pop("watchdog")
    assert got == want
    for a, b in zip(gw.pop("windows"), ww.pop("windows")):
        pa, pb = a.pop("probe_ratio"), b.pop("probe_ratio")
        np.testing.assert_allclose(pa, pb, rtol=1e-4)
        assert a == b
    assert gw == ww


def test_serve_guarded_equals_reference(weights):
    """``serve_guarded`` under the drift spec (the CLI's
    ``--inject-fault``) on the CPU: tokens and resilience log equal to
    the reference's for the same arguments (the reference inits its
    params from the seed; the port is handed the same params)."""
    _, _, tp, _ = weights
    kw = dict(smoke=True, slots=2, prompt_len=8, n_requests=4,
              stop_lengths=(4, 16, 8, 12), segment_iters=4)
    jt, jst = j_serve_guarded("minicpm-2b", fault=_DRIFT_SPEC, **kw)
    tt, tst = serve_guarded("minicpm-2b", fault=_DRIFT_SPEC, device="cpu",
                            params=tp, **kw)
    for rid in jt:
        np.testing.assert_array_equal(tt[rid], np.asarray(jt[rid]))
    _log_equal(tst["resilience"], jst["resilience"])
    assert tst["n_compiles"] == jst["n_compiles"] == 3
    assert tst["fault"] == jst["fault"]
    assert tst["resilience"]["final_rung"] == 2
