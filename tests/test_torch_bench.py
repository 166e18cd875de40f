"""The port's bench twins on the CPU: ``launch/kernel_bench.py`` (twin of
``benchmarks/kernel_bench.py``) and ``launch/fig6_rms.py`` (twin of
``benchmarks/fig6_rms.py``) at the reference's scale.

The kernel bench's rows run and their parity asserts hold, under the
reference's names, and it writes no file unless asked.  Fig. 6's
rounding floor, all-analog and bit-true RMS equal the reference's on the
same numpy conversions and the same (reference-fabricated) dies: the y8
codes are compared with ``==`` and the RMS values are computed by the
reference's own ``_rms_pct``.
"""
import ast
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import baselines as Jb
from repro.core import ccim as Jc
from repro_torch.core import ccim as Tc
from repro_torch.launch import fig6_rms, kernel_bench

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import fig6_rms as ref_fig6  # noqa: E402

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)


def _reference_row_names():
    """The ``record(...)`` op names of benchmarks/kernel_bench.py."""
    tree = ast.parse((ROOT / "benchmarks" / "kernel_bench.py").read_text())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "id", None) == "record"
            and isinstance(node.args[0], ast.Constant)}


def test_kernel_bench_twin_cpu(tmp_path, capsys):
    bench_json = ROOT / "BENCH_kernels.json"
    before = bench_json.read_bytes() if bench_json.exists() else None
    out = tmp_path / "rows.json"
    assert kernel_bench.main(["--device", "cpu", "--scale", "ref",
                              "--quick", "--out", str(out)]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    header, rows = lines[0], lines[1:]
    assert header["device"] == "cpu" and header["scale"] == "ref"
    assert json.loads(out.read_text())["records"] == rows
    assert {r["op"] for r in rows} == _reference_row_names()
    by_op = {r["op"]: r for r in rows}
    for op in ("bit_true_emulation", "fast_emulation"):
        assert "analog noise of the reference's key" in by_op[op]["note"]
    for op in ("fast_gemm_matmulized", "decode_gemm_prepacked",
               "decode_gemm_fused_qkv", "complex_gemm_matmulized"):
        assert "bit-identical" in by_op[op]["note"]
    assert by_op["decode_gemm_prepacked"]["speedup_vs_prev"] >= \
        kernel_bench.DECODE_SPEEDUP_FLOOR
    for op in ("decode_skinny_pallas", "complex_fused_kernel",
               "decode_complex_fused_prepacked"):
        assert by_op[op]["us"] is None and "bit-identical" in \
            by_op[op]["note"]
    # the noisy rows' errors are the reference's (rows 1-2 of
    # benchmarks/kernel_bench.py, under jax.jit as it runs them)
    want = _reference_noisy_rows()
    for op in ("bit_true_emulation", "fast_emulation"):
        err = re.search(r"max FS-rel err ([0-9.]+)",
                        by_op[op]["note"]).group(1)
        assert err == want[op][1], (op, err, want[op][1])
        assert 0 < float(err) < 0.02
    after = bench_json.read_bytes() if bench_json.exists() else None
    assert before == after


def _reference_noisy_rows(seed: int = 0):
    """{op: (output, "max FS-rel err" as the reference prints it)} of the
    reference's two noisy kernel-bench rows."""
    cfg = Jc.DEFAULT_CONFIG
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    M, K, N = kernel_bench.FIDELITY_SHAPE
    x = jax.random.normal(k1, (M, K))
    w = jax.random.normal(k2, (K, N))
    macro = Jc.fabricate(key, cfg)
    y_bit = jax.jit(lambda a, b: Jc.cim_matmul(
        a, b, cfg, noise_key=key, macro=macro, fidelity="bit_true"))(x, w)
    y_fast = jax.jit(lambda a, b: Jc.cim_matmul(
        a, b, cfg, noise_key=key, fidelity="fast"))(x, w)
    ref = x @ w
    fs = float(jnp.abs(x).max() * jnp.abs(w).max() * K)
    return {op: (y, f"{float(jnp.abs(y - ref).max()) / fs:.4f}")
            for op, y in (("bit_true_emulation", y_bit),
                          ("fast_emulation", y_fast))}


def test_noisy_bench_rows_equal_reference():
    """The twin's operands, die and key are the reference's, and its two
    noisy rows' outputs equal the reference's with ``==``."""
    want = _reference_noisy_rows()
    x, w, macro, key = kernel_bench.fidelity_operands(0, "cpu")
    jkey = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(jkey)
    M, K, N = kernel_bench.FIDELITY_SHAPE
    np.testing.assert_array_equal(
        np.asarray(jax.random.normal(k1, (M, K))), x.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.normal(k2, (K, N))), w.numpy())
    got = {"bit_true_emulation": Tc.cim_matmul(
               x, w, Tc.DEFAULT_CONFIG, key, "bit_true", macro=macro),
           "fast_emulation": Tc.cim_matmul(x, w, Tc.DEFAULT_CONFIG, key)}
    for op, (y, _) in want.items():
        np.testing.assert_array_equal(np.asarray(y), got[op].numpy(),
                                      err_msg=op)


def test_fig6_twin_cpu(capsys):
    out = fig6_rms.run(seed=0, device="cpu")
    rows = {json.loads(s)["name"]: json.loads(s)
            for s in capsys.readouterr().out.splitlines()}
    r = out["rms"]
    assert rows["fig6.rms_this_work_pct"]["value"] == r["this_work"]
    assert 0.1 < r["floor"] < r["this_die"] < r["this_work"] < 1.0
    assert 0 < r["all_analog"]
    assert rows["fig6.rms_all_digital_pct"]["value"] == 0.0
    assert 30 < rows["fig6.tops_per_watt"]["value"] < 40


def test_fig6_rows_equal_reference(monkeypatch):
    """The twin's draws are the reference's (seed 0, n = 16,384, as
    benchmarks/fig6_rms.py draws them): operands, both dies and the
    noise key; every row's codes equal the reference's (this work under
    ``jax.jit``, as the reference times it), and so do the RMS values the
    reference prints: 0.408 % this work, 0.226 % the floor, 0.339 %
    all-analog."""
    cfg = Jc.DEFAULT_CONFIG
    n = fig6_rms.REF_N
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    xq = jax.random.randint(ks[0], (n, cfg.acc_len), -127, 128).clip(-127, 127)
    wq = jax.random.randint(ks[1], (n, cfg.acc_len), -127, 128).clip(-127, 127)
    macro = Jc.fabricate(ks[2], cfg)
    cfg_a = Jb.all_analog_config(cfg)
    macro_a = Jc.fabricate(ks[3], cfg_a)
    work = jax.jit(lambda a, b, k: Jc.hybrid_mac_bit_true(
        a, b, macro, cfg, noise_key=k))(xq, wq, ks[3])
    bit = jax.jit(lambda a, b: Jc.hybrid_mac_bit_true(a, b, macro, cfg))(
        xq, wq)
    ideal = Jc.hybrid_mac_ideal(xq, wq, cfg)
    analog = Jc.hybrid_mac_bit_true(xq, wq, macro_a, cfg_a)
    want = {"this_work": work["y8"], "floor": ideal, "this_die": bit["y8"],
            "all_analog": analog["y8"]}

    txq, twq, tmacro, tmacro_a, tkey = fig6_rms.conversions(
        0, n, Tc.DEFAULT_CONFIG)
    np.testing.assert_array_equal(np.asarray(xq), txq.numpy())
    np.testing.assert_array_equal(np.asarray(wq), twq.numpy())
    np.testing.assert_array_equal(np.asarray(ks[3]).astype(np.int64),
                                  tkey.numpy())
    for jm, tm in ((macro, tmacro), (macro_a, tmacro_a)):
        for f in ("eps_array", "adc_cap_eps", "vref_pol_eps"):
            np.testing.assert_array_equal(np.asarray(getattr(jm, f)),
                                          getattr(tm, f).numpy())
    monkeypatch.setitem(fig6_rms.CHUNK, "cpu", 5000)     # a ragged last chunk
    ys = fig6_rms.evaluate(txq, twq, tmacro, tmacro_a, tkey,
                           Tc.DEFAULT_CONFIG)
    for k, v in want.items():
        n_codes = int((np.asarray(v) != ys[k].numpy()).sum())
        assert n_codes == 0, (k, n_codes)
    np.testing.assert_array_equal(np.asarray(bit["exact"]),
                                  ys["exact"].numpy())
    got = fig6_rms.rows(ys, Tc.DEFAULT_CONFIG)
    exact = jnp.asarray(ys["exact"].numpy())
    assert got["this_work"] == ref_fig6._rms_pct(work["y8"], exact, cfg)
    assert got["floor"] == ref_fig6._rms_pct(ideal, exact, cfg)
    assert got["all_analog"] == ref_fig6._rms_pct(analog["y8"], exact, cfg_a)
    assert got["this_die"] == ref_fig6._rms_pct(bit["y8"], exact, cfg)
    assert [f"{got[k]:.3f}" for k in ("this_work", "floor", "all_analog")
            ] == ["0.408", "0.226", "0.339"]
