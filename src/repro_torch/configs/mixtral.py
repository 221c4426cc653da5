"""mixtral-8x22b [arXiv:2401.04088]: sparse mixture of experts, 8 experts
of width 16384 with top-2 routing in every layer, no shared expert.  56
layers, d_model 6144, 48 q heads over 8 kv heads of 128, a sliding window
of 4096, vocab 32768, rope_theta 1e6, an untied LM head.  Its experts hold
4.83 GB of bf16 a layer (282 GB over 56 layers): one card serves it only at
a cut depth.  A copy of the JAX package's ``configs/mixtral.py``."""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=32_768,
    n_experts=8,
    top_k=2,
    moe_d_ff=16_384,
    sliding_window=4096,      # pool note: SWA
    rope_theta=1_000_000.0,
    act="silu",
    gated_ffn=True,
    tie_embeddings=False,
    max_seq_len=65_536,
    source="arXiv:2401.04088; hf tier",
))
