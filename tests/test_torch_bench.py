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
from repro_torch import convert
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
        assert "noise-free" in by_op[op]["note"]
    for op in ("fast_gemm_matmulized", "decode_gemm_prepacked",
               "decode_gemm_fused_qkv", "complex_gemm_matmulized"):
        assert "bit-identical" in by_op[op]["note"]
    assert by_op["decode_gemm_prepacked"]["speedup_vs_prev"] >= \
        kernel_bench.DECODE_SPEEDUP_FLOOR
    for op in ("decode_skinny_pallas", "complex_fused_kernel",
               "decode_complex_fused_prepacked"):
        assert by_op[op]["us"] is None and "bit-identical" in \
            by_op[op]["note"]
    # the bit-true rows' errors stay near the ADC floor
    err = float(re.search(r"max FS-rel err ([0-9.]+)",
                          by_op["bit_true_emulation"]["note"]).group(1))
    assert 0 < err < 0.01
    after = bench_json.read_bytes() if bench_json.exists() else None
    assert before == after


def test_fig6_twin_cpu(capsys):
    out = fig6_rms.run(seed=0, device="cpu")
    rows = {json.loads(s)["name"]: json.loads(s)
            for s in capsys.readouterr().out.splitlines()}
    assert rows["fig6.rms_this_work_pct"]["value"] is None
    assert "not ported" in rows["fig6.rms_this_work_pct"]["note"]
    r = out["rms"]
    assert 0.1 < r["floor"] < r["this_die"] < 1.0 and 0 < r["all_analog"]
    assert rows["fig6.rms_all_digital_pct"]["value"] == 0.0
    assert 30 < rows["fig6.tops_per_watt"]["value"] < 40


def test_fig6_rows_equal_reference(monkeypatch):
    """The reference's n = 16,384 uniform conversions and its dies, drawn
    by the reference from seed 0 as benchmarks/fig6_rms.py draws them."""
    cfg = Jc.DEFAULT_CONFIG
    n = fig6_rms.REF_N
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    xq = jax.random.randint(ks[0], (n, cfg.acc_len), -127, 128).clip(-127, 127)
    wq = jax.random.randint(ks[1], (n, cfg.acc_len), -127, 128).clip(-127, 127)
    macro = Jc.fabricate(ks[2], cfg)
    cfg_a = Jb.all_analog_config(cfg)
    macro_a = Jc.fabricate(ks[3], cfg_a)
    bit = jax.jit(lambda a, b: Jc.hybrid_mac_bit_true(a, b, macro, cfg))(
        xq, wq)
    ideal = Jc.hybrid_mac_ideal(xq, wq, cfg)
    analog = Jc.hybrid_mac_bit_true(xq, wq, macro_a, cfg_a)
    want = {"floor": ideal, "this_die": bit["y8"], "all_analog": analog["y8"]}

    tm = lambda m: convert.macro_from_jax(
        jax.tree_util.tree_map(np.asarray, m), "cpu")
    monkeypatch.setitem(fig6_rms.CHUNK, "cpu", 5000)     # a ragged last chunk
    ys = fig6_rms.evaluate(torch.from_numpy(np.array(xq)),
                           torch.from_numpy(np.array(wq)), tm(macro),
                           tm(macro_a), Tc.DEFAULT_CONFIG)
    for k, v in want.items():
        n_codes = int((np.asarray(v) != ys[k].numpy()).sum())
        assert n_codes == 0, (k, n_codes)
    np.testing.assert_array_equal(np.asarray(bit["exact"]),
                                  ys["exact"].numpy())
    got = fig6_rms.rows(ys, Tc.DEFAULT_CONFIG)
    exact = jnp.asarray(ys["exact"].numpy())
    assert got["floor"] == ref_fig6._rms_pct(ideal, exact, cfg)
    assert got["all_analog"] == ref_fig6._rms_pct(analog["y8"], exact, cfg_a)
    assert got["this_die"] == ref_fig6._rms_pct(bit["y8"], exact, cfg)
