"""Port parity: MUSIC direction of arrival on the complex macro
(``repro_torch.launch.doa``) against the reference's figS3 pipeline at
its own size: an 8-sensor ULA, 64 snapshots, 2 sources, a 0.5 degree
grid, noise-free on the macro on both sides.

The reference side is built from ``benchmarks/figS3_doa.py``'s
``_steering`` and ``_estimate`` and ``complex_cim_matmul(...,
noise_key=None)``; frames are drawn with numpy and handed to both.
Steering matrix, covariance, covariance ints and the spectrum (fed the
reference's eigenvectors) are compared with ``==``: the port reproduces
the reference's CPU arithmetic (libm sinf/cosf, XLA's complex abs and
its summation order).  Each side's own eigh may pick other eigenvector
phases, so there the estimates must be equal, not the spectra.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.figS3_doa import _estimate, _steering
from repro.core import DEFAULT_CONFIG
from repro.core.complex_mac import complex_cim_matmul as jax_ccm
from repro.core.complex_mac import complex_cim_matmul_int as jax_ccm_int
from repro_torch.core.complex_mac import quantize_complex
from repro_torch.core.engine import pack_complex_cim_weights
from repro_torch.launch import doa

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

REF = doa.ARRAYS["ref"]
GRID = np.arange(-60.0, 60.5, 0.5)          # figS3's grid


def _jax_spectrum(En, A):
    proj = jax_ccm(jnp.asarray(En).conj().T, jnp.asarray(A), DEFAULT_CONFIG,
                   noise_key=None)
    return np.asarray(
        1.0 / jnp.maximum(jnp.sum(jnp.abs(proj) ** 2, axis=0), 1e-9))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    return [doa.draw_frame(rng, REF) for _ in range(3)]


def test_grid_and_steering_bit_identical():
    assert np.array_equal(doa.angle_grid(REF.grid_step), GRID)
    assert len(doa.angle_grid(0.05)) == 2401
    for thetas in (GRID, np.array([-24.0, 17.0, 3.3])):
        np.testing.assert_array_equal(
            np.asarray(_steering(REF.n_sensors, thetas)),
            doa.steering(REF.n_sensors, thetas, "cpu").numpy())


def test_covariance_and_ints_bit_identical(frames):
    for _, x in frames:
        X = jnp.asarray(x)
        R_ref = jax_ccm(X, X.conj().T, DEFAULT_CONFIG, noise_key=None) / 64
        R, (y_re, y_im) = doa.covariance(torch.from_numpy(x))
        np.testing.assert_array_equal(np.asarray(R_ref), R.numpy())
        q_re, q_im, _ = quantize_complex(torch.from_numpy(x), -1)
        j = lambda v: jnp.asarray(v.numpy())
        ref_re, ref_im = jax_ccm_int(j(q_re), j(q_im), j(q_re.t()),
                                     j(-q_im.t()))
        np.testing.assert_array_equal(np.asarray(ref_re), y_re.numpy())
        np.testing.assert_array_equal(np.asarray(ref_im), y_im.numpy())


def test_spectrum_bit_identical_on_reference_eigenvectors(frames):
    A = np.asarray(_steering(REF.n_sensors, GRID))
    pack = pack_complex_cim_weights(torch.from_numpy(A.real.copy()),
                                    torch.from_numpy(A.imag.copy()))
    for _, x in frames:
        X = jnp.asarray(x)
        R = jax_ccm(X, X.conj().T, DEFAULT_CONFIG, noise_key=None) / 64
        En = np.array(jnp.linalg.eigh(R)[1][:, :REF.n_sensors - 2])
        p_ref = _jax_spectrum(En, A)
        p = doa.music_spectrum(torch.from_numpy(En), pack)
        np.testing.assert_array_equal(p_ref, p.numpy())


def test_estimates_equal_with_own_eigh(frames):
    A = doa.steering(REF.n_sensors, GRID, "cpu")
    pack = pack_complex_cim_weights(A.real, A.imag)
    for true, x in frames:
        X = jnp.asarray(x)
        R = jax_ccm(X, X.conj().T, DEFAULT_CONFIG, noise_key=None) / 64
        En = np.array(jnp.linalg.eigh(R)[1][:, :REF.n_sensors - 2])
        est_ref = _estimate(_jax_spectrum(En, np.asarray(A)), GRID, 2)
        fr = doa.music_frame(torch.from_numpy(x), pack, GRID, 2)
        assert fr.est == [float(v) for v in est_ref]
        assert doa.rmse(fr.est, true) < 1.0


def test_run_and_cli_at_reference_size(capsys):
    out = doa.run("ref", n_frames=3, seed=0, device="cpu")
    assert out["rmse_pct_fov"] < doa.RMSE_LIMIT_PCT
    assert len(out["frames"]) == 3 and out["grid"].shape == (241,)
    assert doa.main(["--device", "cpu", "--frames", "2"]) == 0
    text = capsys.readouterr().out
    assert "C-CIM MUSIC" in text and "of FOV" in text
