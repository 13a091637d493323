from repro_torch.optim.adamw import Optimizer, adamw, clip_by_global_norm

__all__ = ["Optimizer", "adamw", "clip_by_global_norm"]
