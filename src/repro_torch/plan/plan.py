"""DeploymentPlan: the per-projection D/A split as a static, hashable value.

Counterpart of ``repro/plan/plan.py`` (plain Python over the port's own
``CCIMConfig``).  A plan maps a projection path to a ``PlanEntry`` (a
macro config and an execution fidelity).  It is static metadata, not
tensors: entries are a name-sorted tuple, so the whole plan is hashable
and rides inside the frozen ``ModelConfig``.  ``models.layers`` resolves
each projection's path against it (``cim_engine``), and
``lm.pack_cim_params`` packs each projection under its own entry.

Path convention: the params-tree path with the stacked-layer key
``"layers"`` dropped (``"attn/wq"``, ``"mlp/w2"``).  Lookup falls back
from the full path to the basename (``{"wq": ...}`` targets every wq) to
the plan's default.

Fidelities a plan may assign (``PLAN_FIDELITIES``):

  float   bypass the macro (a bf16 matmul on the raw weights);
  exact   all-digital CIM: the exact integer MAC of the SMF-quantized
          operands;
  fast    the hybrid or all-analog macro at the entry's ``CCIMConfig``
          (through the prepacked kernels on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple

from ..core.ccim import CCIMConfig, DEFAULT_CONFIG

PLAN_FIDELITIES = ("float", "exact", "fast")


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One projection's execution assignment: macro config + fidelity."""

    cfg: CCIMConfig = DEFAULT_CONFIG
    fidelity: str = "fast"
    label: str = ""                    # human-readable candidate name

    def __post_init__(self):
        if self.fidelity not in PLAN_FIDELITIES:
            raise ValueError(
                f"plan fidelity {self.fidelity!r} not in {PLAN_FIDELITIES} "
                "(bit_true needs a fabricated macro instance and is a "
                "profiling tool, not a deployment fidelity)")


FLOAT_ENTRY = PlanEntry(fidelity="float", label="float")
DIGITAL_ENTRY = PlanEntry(fidelity="exact", label="digital")
HYBRID_ENTRY = PlanEntry(fidelity="fast", label="hybrid3")  # paper prototype


@dataclasses.dataclass(frozen=True)
class DeploymentPlan:
    """Projection path -> PlanEntry, with a default for unlisted paths.

    ``entries`` is a name-sorted tuple of ``(path, PlanEntry)`` pairs, so
    two plans with the same assignment compare and hash equal whatever
    the order they were built in.  Build with ``DeploymentPlan.from_dict``.
    """

    entries: Tuple[Tuple[str, PlanEntry], ...] = ()
    default: PlanEntry = FLOAT_ENTRY

    @classmethod
    def from_dict(cls, entries: Mapping[str, PlanEntry],
                  default: PlanEntry = FLOAT_ENTRY) -> "DeploymentPlan":
        return cls(entries=tuple(sorted(entries.items())), default=default)

    @classmethod
    def uniform(cls, entry: PlanEntry) -> "DeploymentPlan":
        """A global single-config plan (the baseline a planner beats)."""
        return cls(entries=(), default=entry)

    def as_dict(self) -> Dict[str, PlanEntry]:
        return dict(self.entries)

    def resolve(self, path: Optional[str]) -> PlanEntry:
        """Entry for ``path``: exact match, then basename, then default."""
        if path is None:
            return self.default
        d = dict(self.entries)
        if path in d:
            return d[path]
        base = path.rsplit("/", 1)[-1]
        if base in d:
            return d[base]
        return self.default

    def replace_entry(self, path: str, entry: PlanEntry) -> "DeploymentPlan":
        d = self.as_dict()
        d[path] = entry
        return DeploymentPlan.from_dict(d, default=self.default)

    def summary(self) -> Dict[str, str]:
        """path -> short label (for reports)."""
        def name(e: PlanEntry) -> str:
            if e.label:
                return e.label
            if e.fidelity != "fast":
                return e.fidelity
            return (f"hybrid{e.cfg.n_dcim_products}/adc{e.cfg.adc_bits}"
                    f"/L{e.cfg.acc_len}")
        out = {p: name(e) for p, e in self.entries}
        out["<default>"] = name(self.default)
        return out


def plan_for_sites(sites: Iterable[str], entry: PlanEntry,
                   default: PlanEntry = FLOAT_ENTRY) -> DeploymentPlan:
    """Every listed site at ``entry`` (profiling, global baselines)."""
    return DeploymentPlan.from_dict({s: entry for s in sites}, default=default)
