from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, sgd, clip_by_global_norm, clip_by_global_norm_,
    cosine_schedule, warmup_cosine, constant_schedule,
)
