"""Weight bridge from the reference package's trees, passed as numpy.

``params_from_jax`` takes the nested dict that the reference ``lm.init``
returns, with every leaf already a numpy array (bfloat16 leaves converted
to float32 by the caller: ``torch.from_numpy`` rejects ml_dtypes'
bfloat16), and returns the port's float params, each leaf in the dtype
the reference gives it: the config's dtype, but float32 for the Mamba2
and MoE leaves the reference keeps in float32 (``A_log``, ``D_skip``,
``dt_bias``, ``router``).  The f32 -> bf16 round trip of a bf16 value is exact.

``packed_from_jax`` maps a reference ``PackedCimWeights`` or
``FusedPackedCimWeights`` (numpy leaves, any object with the reference
field names) onto the port's structure, so tests can compare pack
contents field for field; ``packed_complex_from_jax`` does the same for
a ``PackedComplexCimWeights``.  ``macro_from_jax`` carries a fabricated
die (``MacroInstance``) across: the two packages draw their mismatch
from different generators, so a die is the state two runs must share.
``plan_from_jax`` builds the port's ``DeploymentPlan`` from a reference
plan, entry for entry.  ``opt_state_from_jax`` carries a reference
AdamW state (step, m, v) across, so one update runs on both sides from
the same state.  No function here imports the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device
from .core.ccim import CCIMConfig, MacroInstance
from .core.engine import (FusedPackedCimWeights, PackedCimWeights,
                          PackedComplexCimWeights)
from .kernels.ccim_matmul.ops import weight_layout
from .models.config import ModelConfig
from .models.lm import torch_dtype
from .plan import DeploymentPlan, PlanEntry


# leaves the reference's init makes in float32 whatever the model dtype
# (repro/models/layers.py::mamba2_init, ::moe_init): a bf16 A_log would
# move every decay, a bf16 router every routing logit
FLOAT32_LEAVES = frozenset({"A_log", "D_skip", "dt_bias", "router"})


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> Dict[str, Any]:
    """Reference float params (numpy leaves) -> port params on ``device``.
    Stacked ``layers`` leaves keep their leading layer axis."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def conv(v, name=""):
        if isinstance(v, dict):
            return {k: conv(x, k) for k, x in v.items()}
        dt = torch.float32 if name in FLOAT32_LEAVES else dtype
        return torch.from_numpy(np.array(v, np.float32)).to(dev, dt)
    return conv(tree)


def opt_state_from_jax(state: Dict[str, Any], moment_dtype: str = "float32",
                       device=None) -> Dict[str, Any]:
    """Reference ``init_opt_state`` / ``adamw_update`` state (numpy
    leaves, bfloat16 moments converted to float32 by the caller) -> the
    port's: ``step`` a 0-d int32, ``m`` and ``v`` in ``moment_dtype``."""
    dev = resolve_device(device)
    mdt = torch_dtype(moment_dtype)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v, np.float32)).to(dev, mdt)
    out = {"step": torch.tensor(int(np.asarray(state["step"])),
                                dtype=torch.int32, device=dev),
           "m": conv(state["m"]), "v": conv(state["v"])}
    if "accum" in state:
        out["accum"] = conv(state["accum"])
        out["micro"] = torch.tensor(int(np.asarray(state["micro"])),
                                    dtype=torch.int32, device=dev)
    return out


def _config(cfg) -> CCIMConfig:
    return CCIMConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(CCIMConfig)})


def plan_from_jax(plan) -> DeploymentPlan:
    """Reference ``DeploymentPlan`` (any object with its ``entries`` and
    ``default``, each entry with ``cfg``, ``fidelity`` and ``label``) ->
    the port's, over the port's ``CCIMConfig``."""
    def entry(e) -> PlanEntry:
        return PlanEntry(cfg=_config(e.cfg), fidelity=e.fidelity,
                         label=e.label)
    return DeploymentPlan(entries=tuple((p, entry(e))
                                        for p, e in plan.entries),
                          default=entry(plan.default))


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


def packed_complex_from_jax(p, device=None) -> PackedComplexCimWeights:
    """Reference complex pack (numpy leaves) -> the port's: each half
    through ``packed_from_jax``."""
    return PackedComplexCimWeights(re=packed_from_jax(p.re, device),
                                   im=packed_from_jax(p.im, device))


def macro_from_jax(m, device=None) -> MacroInstance:
    """Reference ``MacroInstance`` (numpy leaves) -> the port's, float32."""
    dev = resolve_device(device)
    conv = lambda v: torch.from_numpy(np.array(v, np.float32)).to(dev)
    return MacroInstance(conv(m.eps_array), conv(m.adc_cap_eps),
                         conv(m.vref_pol_eps))
