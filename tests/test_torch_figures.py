"""The figure twins on the CPU against the reference benches:
``launch/figS2_montecarlo.py``, ``fig5_transfer.py``, ``figS1_cost.py``
and ``fig2_contribution.py`` (twins of ``benchmarks/...``).

Each twin draws the reference's operands and dies from the same
``jax.random`` keys (``core/prng.py``), so every printed line equals the
reference bench's line, character for character (fig5's sweep time
excluded).  Beneath the printed rounding: figS2's per-die RMS values
equal the reference's ``_die_rms`` with ``==`` (the same float64 mean
over the same integer errors), its all-analog rows included; fig5's 255
codes equal the reference's compiled bit-true sweep; figS1's
equivalence row's Re outputs equal the reference baselines'.
"""
import contextlib
import dataclasses
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import DEFAULT_CONFIG as J_DEFAULT
from repro.core import baselines as Jb
from repro.core import fabricate as jfabricate
from repro.core import hybrid_mac_bit_true as jbit_true
from repro_torch.launch import (fig2_contribution, fig5_transfer, figS1_cost,
                                figS2_montecarlo)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import fig2_contribution as ref_fig2  # noqa: E402
from benchmarks import fig5_transfer as ref_fig5  # noqa: E402
from benchmarks import figS1_cost as ref_figS1  # noqa: E402
from benchmarks import figS2_montecarlo as ref_figS2  # noqa: E402

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return buf.getvalue().splitlines(), out


def _rows_equal(want, got, skip_us=()):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        wn, wus, wd = w.split(",", 2)
        gn, gus, gd = g.split(",", 2)
        assert (gn, gd) == (wn, wd)
        if gn not in skip_us:
            assert gus == wus, gn


def test_fig2_twin_prints_reference_rows():
    want, _ = _printed(ref_fig2.run)
    got, rows = _printed(fig2_contribution.run)
    _rows_equal(want, got)
    assert list(rows) == [w.split(",")[0] for w in want]


def test_figS1_twin_prints_reference_rows():
    want, _ = _printed(ref_figS1.run)
    got, rows = _printed(lambda: figS1_cost.run(device="cpu"))
    _rows_equal(want, got)
    # the equivalence row's outputs, beneath its max |err|
    ks = jax.random.split(jax.random.PRNGKey(0), 6)
    q = lambda k: jax.random.randint(k, (4, J_DEFAULT.acc_len), -127,
                                     128).clip(-127, 127)
    xr, xi, wr, wi = q(ks[0]), q(ks[1]), q(ks[2]), q(ks[3])
    m1, m2 = jfabricate(ks[4]), jfabricate(ks[5])
    d_re, _ = Jb.duplicated_cmac(xr, xi, wr, wi, m1, m2)
    s_re, _ = Jb.sequential_cmac(xr, xi, wr, wi, m1)
    eq = rows["figS1.functional_equivalence"]
    assert eq["d_re"] == np.asarray(d_re).tolist()
    assert eq["s_re"] == np.asarray(s_re).tolist()


def test_fig5_twin_prints_reference_rows_and_codes():
    want, _ = _printed(ref_fig5.run)
    got, rows = _printed(lambda: fig5_transfer.run(device="cpu"))
    _rows_equal(want, got, skip_us=("fig5.transfer_sweep",))
    macro = jfabricate(jax.random.PRNGKey(0))
    sweep = jnp.arange(-127, 128)
    x = jnp.broadcast_to(sweep[:, None], (255, J_DEFAULT.acc_len))
    w = jnp.full((255, J_DEFAULT.acc_len), -127)
    y8 = jax.jit(lambda a, b: jbit_true(a, b, macro, J_DEFAULT)["y8"])(x, w)
    assert rows["fig5.transfer_sweep"]["y8"] == np.asarray(y8).tolist()
    assert rows["fig5.transfer_sweep"]["us"] > 0


def test_figS2_twin_prints_reference_rows_and_die_values():
    want, _ = _printed(ref_figS2.run)
    got, rows = _printed(lambda: figS2_montecarlo.run(device="cpu"))
    # the twin's all-analog rows come after the reference's sweep
    analog = [g for g in got if "all_analog" in g]
    _rows_equal(want, [g for g in got if "all_analog" not in g])
    assert len(analog) == len(figS2_montecarlo.MULTS)
    data_key = jax.random.PRNGKey(999)
    for mult in (1.0, 4.0):
        for name, cfg in (
                (f"figS2.mc_rms_at_{mult:.1f}x_mismatch",
                 dataclasses.replace(J_DEFAULT, sigma_unit=0.0296 * mult)),
                (f"figS2.mc_rms_all_analog_at_{mult:.1f}x_mismatch",
                 Jb.all_analog_config(dataclasses.replace(
                     J_DEFAULT, sigma_unit=0.0296 * mult)))):
            dies = [float(ref_figS2._die_rms(cfg, jax.random.PRNGKey(i),
                                             data_key)) for i in range(8)]
            assert rows[name]["dies"] == dies, name
            assert rows[name]["mean"] == float(np.mean(dies))
