"""mixtral-8x7b — MoE 8 experts top-2, GQA kv=8, SWA [arXiv:2401.04088].
The closest LM analogue of the paper's sample-and-gather: the router
*samples* experts, the dispatch gathers only selected tokens.  Runs
long_500k (sliding-window attention bounds the KV working set)."""
from repro_torch.models.registry import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, moe_d_ff=14336, vocab_size=32000,
    num_experts=8, experts_per_token=2, routing="softmax",
    sliding_window=4096, rope_theta=1e6,
    subquadratic=True,
))
