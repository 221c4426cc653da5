"""qwen3-0.6b [hf:Qwen/Qwen3-0.6B]: 28 layers, d_model 1024, 16 query heads
over 8 kv heads (GQA, 2 q heads per kv head), head_dim 128, a gated SiLU
FFN of 3072, vocab 151936, tied embeddings, qk-norm (RMSNorm of q and k
per head over head_dim, before RoPE) and rope_theta 1e6.  The first
grouped-query decoder the port serves."""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    gated_ffn=True,
    tie_embeddings=True,
    max_seq_len=40_960,
    source="hf:Qwen/Qwen3-0.6B; hf tier",
))
