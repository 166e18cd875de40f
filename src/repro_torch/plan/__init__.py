"""Deployment plans: the per-projection D/A split, its candidate design
points and the all-analog draft plans of speculative decoding.

Counterpart of ``repro/plan`` without the profiler and the Pareto search
(not ported yet)."""
from .plan import (  # noqa: F401
    DIGITAL_ENTRY,
    FLOAT_ENTRY,
    HYBRID_ENTRY,
    DeploymentPlan,
    PLAN_FIDELITIES,
    PlanEntry,
    plan_for_sites,
)
from .candidates import (  # noqa: F401
    Candidate,
    DEFAULT_COST_WEIGHTS,
    candidates_by_label,
    combined_cost,
    default_candidates,
    digital_candidate,
    make_candidate,
    min_adc_bits,
    prototype_candidate,
)
from .draft import (  # noqa: F401
    derive_draft_entry,
    derive_draft_plan,
    draft_plan_for_model,
    draft_plan_sweep,
)
