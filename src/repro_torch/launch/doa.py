"""MUSIC direction-of-arrival estimation on the complex macro.

Port of the reference's DoA application (``benchmarks/figS3_doa.py``,
with the CLI of ``examples/doa_estimation.py``): per frame the complex
covariance X X^H runs on raw operands through the complex macro GEMM,
the eigendecomposition stays in the digital back end (LAPACK on the
host, ``noise_subspace``), and the noise-subspace projections E_n^H
a(theta) run against the steering matrix, packed once per (array, grid)
because it is stationary.

Frames carry the macro's analog noise as the reference's do: frame t of
seed s draws under ``PRNGKey(s * 100 + t)`` (``frame_key``), the
covariance under that key and the projections under ``fold_in(key, 1)``;
the noisy GEMMs run in torch, off the kernels, as the reference's leave
its Pallas kernels.  Noise-free frames (``noise_key=None``, the CLI's
``--noise-free``) take the fused complex kernels: the unpacked one for
the covariance, the prepacked ones for the spectrum (skinny for M <= 32,
general above).

Arrays (``ARRAYS``): ``ref`` is the reference's size (8-element ULA, 64
snapshots, 2 sources, 0.5 degree grid); ``ula32`` and ``ula64`` are
half-wavelength ULAs of 32 and 64 elements (64 is the antenna count of
the 64T64R radios of 5G NR massive MIMO) on a 0.05 degree grid of
-60..60 degrees (2,401 points), with 1,024 and 4,096 snapshots and 2 and
4 sources at least 12 degrees apart.  Noise is 0.05 per component, as in
figS3.

    PYTHONPATH=src python -m repro_torch.launch.doa            # ula64, card
    PYTHONPATH=src python -m repro_torch.launch.doa --device cpu   # ref size
    PYTHONPATH=src python -m repro_torch.launch.doa --noise-free
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core import prng
from ..core.complex_mac import (complex_cim_matmul, complex_cim_matmul_int,
                                complex_mac_reference, quantize_complex)
from ..core.engine import PackedComplexCimWeights, pack_complex_cim_weights
from ..models.layers import _libm, _window_sum

FIELD_OF_VIEW = 120.0          # degrees: the -60..60 grid
RMSE_LIMIT_PCT = 4.0           # figS3's bound: < 4 % of the field of view
NOISE = 0.05                   # figS3's noise std per real component
MIN_SEPARATION = 12.0          # figS3's least source separation, degrees


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    n_sensors: int
    n_snapshots: int
    n_sources: int
    grid_step: float            # degrees


ARRAYS = {
    "ref": ArrayConfig(8, 64, 2, 0.5),
    "ula32": ArrayConfig(32, 1024, 2, 0.05),
    "ula64": ArrayConfig(64, 4096, 4, 0.05),
}


def angle_grid(step: float) -> np.ndarray:
    """-60..60 degrees in ``step`` increments (float64), the reference's
    ``np.arange(-60.0, 60.5, 0.5)`` at step 0.5."""
    return np.arange(-60.0, 60.0 + step / 2, step)


def steering(n_sensors: int, thetas_deg, device=None) -> torch.Tensor:
    """(n_sensors, G) complex64 half-wavelength ULA steering matrix.

    Bit-identical to the reference's ``_steering``: the angles in
    float32 radians, the phase pi * k * sin(theta) as its float32
    products, and sin/cos from the C library's sinf/cosf, which the
    reference's CPU lowering calls (torch's own float32 sin differs in
    the last bit for about one value in six)."""
    th = torch.deg2rad(torch.tensor(np.asarray(thetas_deg, np.float64),
                                    dtype=torch.float32)).numpy()
    lib = _libm()
    sin_th = np.array([lib.sinf(float(t)) for t in th], np.float32)
    k = np.arange(n_sensors, dtype=np.float32)
    phase = (np.float32(np.pi) * k)[:, None] * sin_th[None, :]
    flat = [float(v) for v in phase.ravel()]
    re = np.array([lib.cosf(v) for v in flat], np.float32)
    im = np.array([lib.sinf(v) for v in flat], np.float32)
    a = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    return a.reshape(phase.shape).to(resolve_device(device))


def _real_dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 (n, K) @ (K, T), the K products summed in order."""
    acc = a[:, :1] * b[:1]
    for k in range(1, a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[k:k + 1]
    return acc


def draw_frame(rng: np.random.Generator, arr: ArrayConfig
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(true angles, X): sources uniform in -50..50 degrees at least
    ``MIN_SEPARATION`` apart, unit-power complex Gaussian signals and
    noise of ``NOISE`` per component -- drawn in figS3's order.  X is
    (n_sensors, n_snapshots) complex64, A S + N evaluated as figS3's
    ``jnp.asarray(A @ S + N, jnp.complex64)`` evaluates it: S and N
    rounded to complex64, the complex product as four float32 real dots
    (re = ar.sr - ai.si, im = ar.si + ai.sr), then + N."""
    n, T, ns = arr.n_sensors, arr.n_snapshots, arr.n_sources
    true = np.sort(rng.uniform(-50, 50, ns))
    while ns > 1 and np.diff(true).min() < MIN_SEPARATION:
        true = np.sort(rng.uniform(-50, 50, ns))
    A = steering(n, true, "cpu").numpy()
    S = ((rng.standard_normal((ns, T))
          + 1j * rng.standard_normal((ns, T))) / np.sqrt(2)
         ).astype(np.complex64)
    N = ((rng.standard_normal((n, T))
          + 1j * rng.standard_normal((n, T))) * NOISE).astype(np.complex64)
    ar, ai, sr, si = A.real, A.imag, S.real, S.imag
    AS = (_real_dot(ar, sr) - _real_dot(ai, si)) + 1j * (
        _real_dot(ar, si) + _real_dot(ai, sr))
    return true, AS.astype(np.complex64) + N


def frame_key(seed: int, t: int, device=None) -> torch.Tensor:
    """The noise key of frame ``t`` of a run seeded ``seed``: figS3's
    ``PRNGKey(seed * 100 + t)``."""
    return prng.PRNGKey(seed * 100 + t, resolve_device(device))


def covariance(X: torch.Tensor, *, noise_key=None,
               use_kernel: Optional[bool] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(R, (y_re, y_im)): R = X X^H / T through the complex macro on raw
    operands (with the analog noise of ``noise_key``), and its int32
    Re/Im at x 2^11.

    X is quantized once: X^H's ints and per-column scales are the
    conjugate transpose of X's per-row ones (the same rounding of the
    same values), so R equals the reference's
    ``complex_cim_matmul(X, X.conj().T, noise_key=...) / T`` bit for
    bit."""
    q_re, q_im, s = quantize_complex(X, -1)
    y_re, y_im = complex_cim_matmul_int(q_re, q_im, q_re.t(), -q_im.t(),
                                        noise_key=noise_key,
                                        use_kernel=use_kernel)
    scale = s * s.reshape(1, -1)
    R = torch.complex(y_re * scale, y_im * scale) / X.shape[1]
    return R, (y_re, y_im)


def noise_subspace(R: torch.Tensor, n_sources: int) -> torch.Tensor:
    """E_n: eigenvectors of the n - n_sources smallest eigenvalues (the
    digital back end, Fig. S3's DBP), on R's device.

    As the reference's ``jnp.linalg.eigh`` does, this decomposes
    (R + R^H) / 2 (a noisy covariance is not Hermitian; for a noise-free
    one the average is exact) with LAPACK's divide-and-conquer ``heevd``
    on the host, through SciPy, whose LAPACK the reference's CPU eigh
    calls too: so the eigenvectors are the reference's, and the same on
    every device (another solver may flip an eigenvector's sign or move
    its last bits, which moves the noisy GEMM's codes)."""
    import scipy.linalg
    r = ((R + R.conj().t()) * 0.5).cpu().numpy()
    _, v = scipy.linalg.eigh(r, lower=True, driver="evd")
    return torch.from_numpy(v[:, :R.shape[0] - n_sources]).to(R.device)


def _abs(z: torch.Tensor) -> torch.Tensor:
    """|z| of complex64 as the reference's CPU lowering computes it:
    max * sqrt(fma(q, q, 1)) with q = min / max of |re|, |im|.  The fma
    is taken in float64 (exact product, one rounding of the sum) and
    rounded to float32, the square root correctly rounded
    (``prng.sqrt``), so the card's spectrum is the CPU's."""
    re, im = z.real.abs(), z.imag.abs()
    mx, mn = torch.maximum(re, im), torch.minimum(re, im)
    q = (mn / mx).to(torch.float64)
    r = mx * prng.sqrt((q * q + 1.0).to(torch.float32))
    return torch.where(mx > 0, r, mx)


def _spectrum(proj: torch.Tensor) -> torch.Tensor:
    """1 / max(sum_rows |proj|^2, 1e-9), summed over the rows in the
    reference's compiled order."""
    a = _abs(proj)
    return 1.0 / torch.clamp_min(_window_sum((a * a).t()), 1e-9)


def music_spectrum(En: torch.Tensor, steering_pack: PackedComplexCimWeights,
                   *, noise_key=None, use_kernel: Optional[bool] = None
                   ) -> torch.Tensor:
    """(G,) float32 MUSIC pseudo-spectrum: E_n^H a(theta) on the macro
    against the packed steering matrix (with the analog noise of
    ``noise_key``)."""
    return _spectrum(complex_cim_matmul(En.conj().t(), steering_pack,
                                        noise_key=noise_key,
                                        use_kernel=use_kernel))


def software_spectrum(X: torch.Tensor, A: torch.Tensor,
                      n_sources: int) -> torch.Tensor:
    """fp32 software MUSIC, the paper's comparison target."""
    R = complex_mac_reference(X, X.conj().t()) / X.shape[1]
    En = noise_subspace(R, n_sources)
    return _spectrum(complex_mac_reference(En.conj().t(), A))


def estimate(p, grid: np.ndarray, n_sources: int) -> list:
    """The ``n_sources`` highest peaks more than 5 degrees apart, sorted
    (the reference's ``_estimate``)."""
    p = p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    idx = []
    for i in np.argsort(p)[::-1]:
        if all(abs(grid[i] - grid[j]) > 5 for j in idx):
            idx.append(i)
        if len(idx) == n_sources:
            break
    return sorted(float(grid[i]) for i in idx)


class Frame(NamedTuple):
    r_int: Tuple[torch.Tensor, torch.Tensor]   # covariance ints at x 2^11
    p: torch.Tensor                            # MUSIC pseudo-spectrum
    est: list                                  # estimated angles


def music_frame(X: torch.Tensor, steering_pack: PackedComplexCimWeights,
                grid: np.ndarray, n_sources: int, *, noise_key=None,
                use_kernel: Optional[bool] = None) -> Frame:
    """One frame of CIM MUSIC: covariance, noise subspace, spectrum,
    peaks; with ``noise_key`` the covariance draws under it and the
    projections under ``fold_in(noise_key, 1)``, as figS3 draws them."""
    R, r_int = covariance(X, noise_key=noise_key, use_kernel=use_kernel)
    spec_key = None if noise_key is None else prng.fold_in(noise_key, 1)
    p = music_spectrum(noise_subspace(R, n_sources), steering_pack,
                       noise_key=spec_key, use_kernel=use_kernel)
    return Frame(r_int, p, estimate(p, grid, n_sources))


def rmse(est, true) -> float:
    return float(np.sqrt(np.mean((np.asarray(est) - np.asarray(true)) ** 2)))


def run(array: str = "ref", n_frames: int = 12, seed: int = 0,
        device=None, noisy: bool = True) -> dict:
    """CIM MUSIC and fp32 software MUSIC over ``n_frames`` seeded frames
    of ``ARRAYS[array]`` (with the macro's analog noise unless ``noisy``
    is False); RMSEs against the true angles as in figS3."""
    arr = ARRAYS[array]
    dev = resolve_device(device)
    grid = angle_grid(arr.grid_step)
    A = steering(arr.n_sensors, grid, dev)
    pack = pack_complex_cim_weights(A.real, A.imag)
    rng = np.random.default_rng(seed)
    frames, cim_s = [], 0.0
    for t in range(n_frames):
        true, x = draw_frame(rng, arr)
        X = torch.from_numpy(x).to(dev)
        key = frame_key(seed, t, dev) if noisy else None
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = music_frame(X, pack, grid, arr.n_sources, noise_key=key)
        cim_s += time.perf_counter() - t0      # estimate() read p back
        est_sw = estimate(software_spectrum(X, A, arr.n_sources), grid,
                          arr.n_sources)
        frames.append(dict(true=true.tolist(), cim=fr.est, software=est_sw,
                           p=fr.p))
    err_cim = [rmse(f["cim"], f["true"]) for f in frames]
    err_sw = [rmse(f["software"], f["true"]) for f in frames]
    return dict(
        array=array, config=dataclasses.asdict(arr), noisy=noisy,
        frames=frames,
        grid=grid, device=str(dev), n_frames=n_frames,
        rmse_cim_deg=float(np.mean(err_cim)),
        rmse_software_deg=float(np.mean(err_sw)),
        rmse_cim_vs_software_deg=float(np.mean(
            [rmse(f["cim"], f["software"]) for f in frames])),
        rmse_pct_fov=float(100 * np.mean(err_cim) / FIELD_OF_VIEW),
        cim_frames_per_s=n_frames / cim_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--array", choices=sorted(ARRAYS), default=None,
                    help="default: ula64 on the card, ref on the CPU")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--noise-free", action="store_true",
                    help="no analog noise: the fused complex kernels")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    array = args.array or ("ula64" if dev.type == "cuda" else "ref")
    out = run(array, args.frames, args.seed, dev, not args.noise_free)
    f0 = out["frames"][0]
    print(f"array {array}: {out['config']} on {out['device']}, "
          f"{'with' if out['noisy'] else 'without'} analog noise")
    print(f"true DOA:          {[round(v, 2) for v in f0['true']]}")
    print(f"software MUSIC:    {f0['software']}")
    print(f"C-CIM MUSIC:       {f0['cim']}")
    p = f0["p"].cpu().numpy()
    p = p / p.max()
    grid = out["grid"]
    stride = max(1, len(grid) // 30)
    print("\nMUSIC spectrum (C-CIM, first frame):")
    for i in range(0, len(grid), stride):
        print(f"{grid[i]:+6.1f} deg |{'#' * int(40 * p[i])}")
    print(f"\nC-CIM RMSE over {out['n_frames']} frames: "
          f"{out['rmse_cim_deg']:.3f} deg ({out['rmse_pct_fov']:.2f}% of "
          f"FOV; paper <{RMSE_LIMIT_PCT:.0f}%); software "
          f"{out['rmse_software_deg']:.3f} deg; {out['cim_frames_per_s']:.1f} "
          f"CIM frames/s on {out['device']}")
    return 0 if out["rmse_pct_fov"] < RMSE_LIMIT_PCT else 1


if __name__ == "__main__":
    raise SystemExit(main())
