"""Port parity: MUSIC direction of arrival on the complex macro
(``repro_torch.launch.doa``, the figS3 twin ``launch/figS3_doa.py``)
against the reference's figS3 pipeline at its own size: an 8-sensor ULA,
64 snapshots, 2 sources, a 0.5 degree grid, noise-free and with the
macro's analog noise.

The reference side is built from ``benchmarks/figS3_doa.py``'s
``_steering``, ``_estimate`` and ``_music_spectrum`` and
``complex_cim_matmul``; frames are drawn by the port and equal figS3's
(the same numpy stream, X rounded as figS3 rounds it).  Steering matrix,
frames, covariance, covariance ints and the spectrum (fed the reference's
eigenvectors) are compared with ``==``: the port reproduces the
reference's CPU arithmetic (libm sinf/cosf, XLA's complex abs and its
summation order) and draws its noise (``core/prng.py``).  The port's own
eigendecomposition is the reference's too (LAPACK ``heevd`` of (R +
R^H) / 2 through SciPy, the LAPACK jax's CPU eigh calls), so its noisy
spectra and estimates equal figS3's as well.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.figS3_doa import _estimate, _music_spectrum, _steering
from repro.core import DEFAULT_CONFIG
from repro.core.complex_mac import complex_cim_matmul as jax_ccm
from repro.core.complex_mac import complex_cim_matmul_int as jax_ccm_int
from repro_torch.core import prng
from repro_torch.core.complex_mac import quantize_complex
from repro_torch.core.engine import pack_complex_cim_weights
from repro_torch.launch import doa, figS3_doa

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

REF = doa.ARRAYS["ref"]
GRID = np.arange(-60.0, 60.5, 0.5)          # figS3's grid


def _jax_spectrum(En, A, key=None):
    proj = jax_ccm(jnp.asarray(En).conj().T, jnp.asarray(A), DEFAULT_CONFIG,
                   noise_key=key)
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


def test_frames_equal_figS3():
    """draw_frame's angles and X equal figS3's trial loop, bit for bit."""
    rng, ours = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(4):
        true = np.sort(rng.uniform(-50, 50, 2))
        while np.diff(true).min() < 12:
            true = np.sort(rng.uniform(-50, 50, 2))
        A = _steering(8, true)
        S = (rng.standard_normal((2, 64))
             + 1j * rng.standard_normal((2, 64))) / np.sqrt(2)
        N = (rng.standard_normal((8, 64))
             + 1j * rng.standard_normal((8, 64))) * 0.05
        X = np.asarray(jnp.asarray(A @ S + N, jnp.complex64))
        t, x = doa.draw_frame(ours, REF)
        assert np.array_equal(t, true) and x.dtype == np.complex64
        np.testing.assert_array_equal(X, x)


def test_noisy_spectrum_bit_identical_on_reference_eigenvectors(frames):
    """With the analog noise: the covariance (its ints too) equals the
    reference's under frame t's key, and the spectrum fed the reference's
    eigenvectors equals its spectrum under ``fold_in(key, 1)``."""
    A = np.asarray(_steering(REF.n_sensors, GRID))
    pack = pack_complex_cim_weights(torch.from_numpy(A.real.copy()),
                                    torch.from_numpy(A.imag.copy()))
    for t, (_, x) in enumerate(frames):
        jk, tk = jax.random.PRNGKey(t), doa.frame_key(0, t, "cpu")
        X = jnp.asarray(x)
        R = jax_ccm(X, X.conj().T, DEFAULT_CONFIG, noise_key=jk) / 64
        R_t, _ = doa.covariance(torch.from_numpy(x), noise_key=tk)
        np.testing.assert_array_equal(np.asarray(R), R_t.numpy())
        clean, _ = doa.covariance(torch.from_numpy(x))
        assert not torch.equal(clean, R_t)
        En = np.array(jnp.linalg.eigh(R)[1][:, :REF.n_sensors - 2])
        p_ref = _jax_spectrum(En, A, jax.random.fold_in(jk, 1))
        p = doa.music_spectrum(torch.from_numpy(En), pack,
                               noise_key=prng.fold_in(tk, 1))
        np.testing.assert_array_equal(p_ref, p.numpy())


def test_figS3_twin_equals_reference():
    """The twin's 12 trials at seed 0: each CIM spectrum and estimate
    equals the reference's ``_music_spectrum(..., cim=True, key)`` (the
    reference's own eigh inside it), and the RMSE meets figS3's bound;
    the rows print the reference's 0.23 deg (CIM), 0.13 deg (software)
    and 36.81 % spectrum NMSE."""
    rows = []
    out = figS3_doa.run(seed=0, n_trials=12, device="cpu", emit=rows.append)
    rng = np.random.default_rng(0)
    for t, trial in enumerate(out["trials"]):
        true, x = doa.draw_frame(rng, REF)
        p_ref = np.asarray(_music_spectrum(jnp.asarray(x), 2, GRID, True,
                                           jax.random.PRNGKey(t)))
        np.testing.assert_array_equal(p_ref, trial["p"].numpy())
        assert trial["cim"] == [float(v) for v in _estimate(p_ref, GRID, 2)]
        assert trial["true"] == true.tolist()
    assert out["rmse_pct_fov"] < doa.RMSE_LIMIT_PCT
    by = {r["name"]: r for r in rows}
    assert f"{by['figS3.doa_rmse_cim_deg']['value']:.2f}" == "0.23"
    assert f"{by['figS3.doa_rmse_software_deg']['value']:.2f}" == "0.13"
    assert f"{by['figS3.spectrum_nmse_pct']['value']:.2f}" == "36.81"


def test_noisy_run_and_figS3_cli(capsys):
    noisy = doa.run("ref", n_frames=2, seed=0, device="cpu")
    clean = doa.run("ref", n_frames=2, seed=0, device="cpu", noisy=False)
    assert noisy["noisy"] and not clean["noisy"]
    assert not torch.equal(noisy["frames"][0]["p"], clean["frames"][0]["p"])
    assert doa.main(["--device", "cpu", "--frames", "2",
                     "--noise-free"]) == 0
    assert "without analog noise" in capsys.readouterr().out
    assert figS3_doa.main(["--device", "cpu", "--trials", "3"]) == 0
    names = [json.loads(s)["name"] for s in
             capsys.readouterr().out.splitlines()[1:]]
    assert names == ["figS3.doa_rmse_cim_deg", "figS3.doa_rmse_software_deg",
                     "figS3.spectrum_nmse_pct"]
