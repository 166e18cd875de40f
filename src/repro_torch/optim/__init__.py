from .adamw import (OptConfig, accumulate_grads, adamw_update,  # noqa: F401
                    global_norm, init_opt_state, tree_leaves, tree_map,
                    tree_unflatten)
from .schedules import make_schedule, warmup_cosine, wsd  # noqa: F401
