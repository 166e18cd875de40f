"""Weight bridge from the reference package's trees, passed as numpy.

``params_from_jax`` takes the nested dict that the reference ``lm.init``
returns, with every leaf already a numpy array (bfloat16 leaves converted
to float32 by the caller: ``torch.from_numpy`` rejects ml_dtypes'
bfloat16), and returns the port's float params in the config's dtype.
The f32 -> bf16 round trip of a bf16 value is exact.

``packed_from_jax`` maps a reference ``PackedCimWeights`` or
``FusedPackedCimWeights`` (numpy leaves, any object with the reference
field names) onto the port's structure, so tests can compare pack
contents field for field.  Neither function imports the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device
from .core.ccim import CCIMConfig
from .core.engine import FusedPackedCimWeights, PackedCimWeights
from .kernels.ccim_matmul.ops import weight_layout
from .models.config import ModelConfig
from .models.lm import torch_dtype


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> Dict[str, Any]:
    """Reference float params (numpy leaves) -> port params on ``device``.
    Stacked ``layers`` leaves keep their leading layer axis."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v)).to(dev, dtype)
    return conv(tree)


def _config(cfg) -> CCIMConfig:
    return CCIMConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(CCIMConfig)})


def packed_from_jax(p, device=None):
    """Reference pack (numpy leaves; a leading layer axis allowed) -> the
    port's pack, built from the reference's Pallas-layout int8 weights
    and planes restricted to the logical K x N region."""
    if hasattr(p, "seg_names"):
        return FusedPackedCimWeights(packed=packed_from_jax(p.packed, device),
                                     seg_names=tuple(p.seg_names),
                                     seg_dims=tuple(p.seg_dims))
    dev = resolve_device(device)
    cfg = _config(p.cfg)
    K, N = p.k_dim, p.n_dim
    Kp, _ = weight_layout(K, N, cfg.acc_len)
    w = np.asarray(p.pallas_w)[..., :K, :N]              # (..., K, N)
    pl = np.asarray(p.pallas_planes)[..., :K, :N]        # (..., n_j, K, N)

    def lay(v):
        t = torch.from_numpy(np.array(np.swapaxes(v, -1, -2)))
        return torch.nn.functional.pad(t, (0, Kp - K)).to(
            dev, torch.int8).contiguous()
    return PackedCimWeights(
        scale=torch.from_numpy(np.array(p.scale, np.float32)).to(dev),
        kernel_w=lay(w), kernel_planes=lay(pl), k_dim=K, n_dim=N, cfg=cfg)
