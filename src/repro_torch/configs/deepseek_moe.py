"""deepseek-moe-16b [hf:deepseek-ai/deepseek-moe-16b-base, arXiv:2401.06066]:
fine-grained mixture of experts.  28 layers, d_model 2048, 16 heads of 128
(kv 16), vocab 102400, an untied LM head; every layer but the first routes
each token to 6 of 64 experts of width 1408 (``moe_d_ff``) beside 2 shared
experts (one dense FFN of 2 x 1408); the first layer is a dense FFN of
10944.  16.4 B parameters, 32.75 GB of bf16, of which the routed experts
are 29.90 GB: the model fits one card whole.  A copy of the JAX package's
``configs/deepseek_moe.py``."""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,                # routed-expert width (pool-specified)
    vocab_size=102_400,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_k_dense=1,
    dense_ff_override=10_944,
    rope_theta=10_000.0,
    act="silu",
    gated_ffn=True,
    tie_embeddings=False,
    max_seq_len=16_384,
    source="arXiv:2401.06066; hf tier",
))
