"""Training of the port: AdamW with its schedule and clip (``optimizer``),
the train step and loop (``trainer``) and gradient compression with error
feedback (``compress``)."""
from repro_torch.train.optimizer import (  # noqa: F401
    AdamWState, OptimizerConfig, adamw_init, adamw_update, clip_by_global_norm,
    cosine_schedule,
)
from repro_torch.train.trainer import (  # noqa: F401
    Trainer, TrainerConfig, make_train_step,
)
