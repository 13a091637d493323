from repro_torch.optim.adamw import (Optimizer, adamw, clip_by_global_norm,
                                     lion, sgd)
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "constant", "lion",
           "sgd", "warmup_cosine"]
