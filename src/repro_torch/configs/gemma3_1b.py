"""gemma3-1b — dense GQA kv=1, 5:1 local:global sliding window, 128k ctx
[hf:google/gemma-3-1b-pt].  Runs long_500k: 5/6 of layers have bounded
(local_window) KV; the few global layers use the seq-sharded near-data
decode attention (DESIGN.md §4)."""
from repro_torch.models.registry import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    local_global_ratio=5, local_window=512,
    qk_norm=True, tie_embeddings=True, embed_scale=True, post_norms=True,
    act="gelu", rope_theta=1e6,
    subquadratic=True,
))
