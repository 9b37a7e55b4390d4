from repro_torch.optim.optimizers import (
    sgd, adam, adamw, clip_by_global_norm, clip_scale, apply_updates,
    global_norm,
)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine
