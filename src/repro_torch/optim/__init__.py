"""The optimizer of the port's training path: AdamW with global-norm
clipping and its schedules (``adamw``), updating parameters in place."""
from .adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    linear_warmup_cosine,
)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
    "cosine_schedule", "global_norm", "linear_warmup_cosine",
]
