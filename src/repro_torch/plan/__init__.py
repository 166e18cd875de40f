"""Deployment plans: the per-projection D/A split, its candidate design
points, the all-analog draft plans of speculative decoding, and the
planner that picks a split per projection (sensitivity profile, greedy
Pareto search, end-to-end validation).

Counterpart of ``repro/plan``."""
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
from .profiler import (  # noqa: F401
    PROFILE_NOISE_SEED,
    SensitivityProfile,
    calibration_batch,
    planned_logits,
    profile_sensitivities,
    reference_logits,
    rel_rms,
)
from .search import (  # noqa: F401
    PlanSearchResult,
    assignment_cost,
    evaluate_plan,
    pareto_search,
    plan_from_assignment,
    predicted_rms,
)
