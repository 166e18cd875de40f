"""Host fingerprinting for benchmark records and graph fingerprints.

Counterpart of ``repro/obs/hostinfo.py``.  A serving number without the
host it ran on is not a trajectory point, just a number:
``host_fingerprint()`` captures the identity that moves the numbers --
the backend, the device and its power limit, the torch and CUDA
versions, python, the platform and the git sha -- and
``host_matches()`` is the comparison under which two op-sequence or
graph fingerprints (``obs/fingerprint.py``) may be compared: the aten op
sequence and the kernels a graph captures are stable for a fixed
(backend, device kind, torch, CUDA) and not across them.
"""
from __future__ import annotations

import platform
import shutil
import subprocess
from typing import Dict, Optional

import torch

# benchmark row schema: bump when a record's field changes meaning
BENCH_SCHEMA_VERSION = 2


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError):
        return None


def _smi_name_power() -> Optional[str]:
    """``name, power.limit`` of the first card as nvidia-smi prints them,
    or None where the tool is absent or fails."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def host_fingerprint(device=None) -> Dict[str, Optional[str]]:
    """The host identity: ``backend`` ("cuda" or "cpu"), ``device_kind``
    (``torch.cuda.get_device_name``, or the CPU's processor string),
    ``torch``, ``cuda`` (``torch.version.cuda``), python, platform and
    git sha; on a card also ``power_limit``, from one nvidia-smi read
    (None where the tool is absent).  ``device`` defaults to CUDA when
    it is available."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    out = dict(
        platform=platform.platform(),
        python=platform.python_version(),
        backend=dev.type,
        device_kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else platform.processor() or platform.machine()),
        torch=torch.__version__,
        cuda=torch.version.cuda,
        git_sha=git_sha(),
    )
    if dev.type == "cuda":
        smi = _smi_name_power()
        out["power_limit"] = (smi.rsplit(",", 1)[-1].strip()
                              if smi and "," in smi else None)
    return out


# the identity under which op-sequence and graph fingerprints compare
_FP_KEYS = ("backend", "device_kind", "torch", "cuda")


def host_matches(a: Optional[Dict], b: Optional[Dict],
                 keys=_FP_KEYS) -> bool:
    """True when ``a`` and ``b`` describe fingerprint-comparable hosts
    (every key present and equal; ``cuda`` is None on both sides of a
    CPU-only build, which does not compare)."""
    if not isinstance(a, dict) or not isinstance(b, dict):
        return False
    return all(a.get(k) is not None and a.get(k) == b.get(k) for k in keys)
