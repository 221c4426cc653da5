"""hymba-1.5b [arXiv:2411.13676]: the hybrid decoder, parallel attention
and Mamba-2 SSD heads in every layer, their outputs fused (``0.5 * (pa +
ps)``) before the residual add.  32 layers, d_model 1600, 25 query heads
over 5 kv heads of 64 (at tp=1 the head layout stores each kv head once
per q head: 25 kv slots), a gated SiLU FFN of 5504, vocab 32001, tied
embeddings, 50 SSD heads of 64 with state 16 and conv 4.  Full attention
at layers {0, 16, 31}, a sliding window of 1024 elsewhere; meta-tokens
omitted (backbone dims only).  A copy of the JAX package's
``configs/hymba.py``."""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,          # 50 SSM heads (d_inner=3200)
    ssm_conv=4,
    ssm_chunk=256,
    sliding_window=1024,
    rope_theta=10_000.0,
    act="silu",
    gated_ffn=True,
    tie_embeddings=True,
    max_seq_len=1_048_576,
    source="arXiv:2411.13676; hf tier",
))
