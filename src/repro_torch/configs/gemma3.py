"""gemma3-12b / gemma3-27b [hf:google/gemma-3-*-pt]: dense decoders with
5 sliding-window layers (1024 keys) to 1 global layer, GQA with qk-norm,
sandwich norms (a norm after each sublayer too), embeddings scaled by
sqrt(d_model) and a gated tanh-gelu FFN, tied embeddings, rope_theta 1e6.
head_dim is 256 (12b) / 128 (27b), decoupled from d_model / n_heads, per
the released configs.  A copy of the JAX package's ``configs/gemma3.py``;
the port serves the 12b on the card (the 27b's 54 GB of bf16 weights wait,
ROADMAP Queue 1 item 5)."""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15_360,
    vocab_size=262_144,
    qk_norm=True,
    sandwich_norm=True,
    scale_embed=True,
    local_global_ratio=5,
    sliding_window=1024,
    rope_theta=1_000_000.0,
    act="gelu",
    gated_ffn=True,
    tie_embeddings=True,
    max_seq_len=131_072,
    source="hf:google/gemma-3-12b-pt; unverified tier",
))

register(ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21_504,
    vocab_size=262_144,
    qk_norm=True,
    sandwich_norm=True,
    scale_embed=True,
    local_global_ratio=5,
    sliding_window=1024,
    rope_theta=1_000_000.0,
    act="gelu",
    gated_ffn=True,
    tie_embeddings=True,
    max_seq_len=131_072,
    source="hf:google/gemma-3-27b-pt; unverified tier",
))
