from repro_torch.optim.adamw import (Optimizer, adamw, clip_by_global_norm,
                                     lion, sgd)
from repro_torch.optim.compression import (compress_int8, compress_topk,
                                           decompress_int8, decompress_topk,
                                           init_error, wire_bytes)
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "compress_int8",
           "compress_topk", "constant", "decompress_int8", "decompress_topk",
           "init_error", "lion", "sgd", "warmup_cosine", "wire_bytes"]
