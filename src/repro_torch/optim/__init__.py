from repro_torch.optim.adam import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, global_norm,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401
