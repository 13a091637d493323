"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), their
plain PyTorch versions (``ref``), and the device-dispatching wrappers
(``ops``).

``LAUNCHES`` counts, per kernel, the launches its wrapper has made since
the last ``reset_launches()``: a run can show that its main path really
went through the kernels.  The plain CPU path counts nothing.
"""

LAUNCHES = {"neighbor_sample": 0, "feature_gather_rows": 0,
            "feature_gather_mean": 0, "neighbor_sample_cached": 0,
            "feature_gather_cached": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "decode_attention": 0, "ssd_chunk_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
