from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update_,
    global_norm,
    named_leaves,
    opt_state_from_arrays,
)
from repro_torch.optim.schedule import cosine_schedule

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update_",
    "cosine_schedule",
    "global_norm",
    "named_leaves",
    "opt_state_from_arrays",
]
