"""Fig. S3: MUSIC direction-of-arrival estimation on the C-CIM macro.

Twin of ``benchmarks/figS3_doa.py``: ``n_trials`` frames of the
reference's array (``doa.ARRAYS["ref"]``: an 8-element half-wavelength
ULA, 64 snapshots, 2 sources at least 12 degrees apart, noise 0.05 per
component, a 0.5 degree grid over -60..60), drawn from
``np.random.default_rng(seed)`` in the reference's order.  Each frame's
complex covariance and spectrum projections run through the macro with
its analog noise under ``PRNGKey(seed * 100 + t)`` (``doa.music_frame``),
the eigendecomposition stays digital.  Rows, one JSON line each:

  * the CIM estimates' RMSE against the true angles, in degrees and in
    % of the 120 degree field of view (paper: < 4 %; the run raises
    ``AssertionError`` above it, as the reference's does);
  * fp32 software MUSIC's RMSE;
  * the spectrum NMSE of the CIM log-spectra against the software ones.

    PYTHONPATH=src python -m repro_torch.launch.figS3_doa      # the card
    PYTHONPATH=src python -m repro_torch.launch.figS3_doa --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..core.engine import pack_complex_cim_weights
from . import doa


def _log_spectrum(p: torch.Tensor) -> np.ndarray:
    p = p.cpu().numpy()
    return 10 * np.log10(p / p.max())


def run(seed: int = 0, n_trials: int = 12, device=None,
        emit: Callable[[dict], None] = lambda row: print(json.dumps(row),
                                                         flush=True)
        ) -> dict:
    """Every trial and row; returns {"trials": [...], "rmse_pct_fov",
    "rmse_cim_deg", "rmse_software_deg", "spectrum_nmse_pct", "us"} with
    ``us`` the mean wall time of one CIM frame (the card synchronized
    after it)."""
    dev = resolve_device(device)
    arr = doa.ARRAYS["ref"]
    ns = arr.n_sources
    grid = doa.angle_grid(arr.grid_step)
    A = doa.steering(arr.n_sensors, grid, dev)
    pack = pack_complex_cim_weights(A.real, A.imag)
    rng = np.random.default_rng(seed)
    trials, cim_s = [], 0.0
    for t in range(n_trials):
        true, x = doa.draw_frame(rng, arr)
        X = torch.from_numpy(x).to(dev)
        p_sw = doa.software_spectrum(X, A, ns)
        t0 = time.perf_counter()
        fr = doa.music_frame(X, pack, grid, ns,
                             noise_key=doa.frame_key(seed, t, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        cim_s += time.perf_counter() - t0
        ps, pc = _log_spectrum(p_sw), _log_spectrum(fr.p)
        trials.append(dict(true=true.tolist(), cim=fr.est,
                           software=doa.estimate(p_sw, grid, ns),
                           spectrum_nmse=float(np.linalg.norm(pc - ps)
                                               / np.linalg.norm(ps)),
                           r_int=fr.r_int, p=fr.p))
    err_cim = [doa.rmse(r["cim"], r["true"]) for r in trials]
    err_sw = [doa.rmse(r["software"], r["true"]) for r in trials]
    out = dict(trials=trials, us=1e6 * cim_s / n_trials,
               rmse_cim_deg=float(np.mean(err_cim)),
               rmse_software_deg=float(np.mean(err_sw)),
               rmse_pct_fov=float(100 * np.mean(err_cim)
                                  / doa.FIELD_OF_VIEW),
               spectrum_nmse_pct=float(100 * np.mean(
                   [r["spectrum_nmse"] for r in trials])))
    emit(dict(name="figS3.doa_rmse_cim_deg", value=out["rmse_cim_deg"],
              us=out["us"], pct_fov=out["rmse_pct_fov"], trials=n_trials,
              note="CIM MUSIC with the macro's analog noise (paper: < 4% "
                   "of the field of view vs software); us: one frame"))
    emit(dict(name="figS3.doa_rmse_software_deg",
              value=out["rmse_software_deg"], note="fp32 MUSIC reference"))
    emit(dict(name="figS3.spectrum_nmse_pct", value=out["spectrum_nmse_pct"],
              note="log-spectrum NMSE of CIM vs software"))
    assert out["rmse_pct_fov"] < doa.RMSE_LIMIT_PCT, "paper claim violated"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device ('cpu' for the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trials", type=int, default=12)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(json.dumps(dict(bench="figS3", device=(
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        seed=args.seed, trials=args.trials)), flush=True)
    run(args.seed, args.trials, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
