"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone
[arXiv:2308.11596].  The speech frontend is a STUB per the assignment:
input_specs() supplies precomputed frame embeddings for the encoder;
the decoder consumes text tokens."""
from repro_torch.models.registry import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    encoder_layers=24, enc_seq_divisor=4, act="gelu", rope_theta=1e4,
    subquadratic=False,
))
