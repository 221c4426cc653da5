"""mamba2-370m [arXiv:2405.21060]: 48 SSD layers, d_model 1024, no FFN
blocks, vocab 50280, state 128.  Mamba-2 defaults: expand 2 (d_inner
2048), head_dim 64 (32 SSD heads), conv width 4, one B/C group.  The
attention-free config the SSM slice of the port serves from state slabs."""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,            # SSD heads = d_inner / ssm_head_dim
    n_kv_heads=32,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    norm="rmsnorm",
    rope_theta=0.0,        # no RoPE (SSM positions are implicit)
    max_seq_len=1_048_576,
    source="arXiv:2405.21060 (mamba2-370m); unverified tier",
))
