"""seamless-m4t-large-v2 [arXiv:2308.11596]: an encoder-decoder, 24
encoder and 24 decoder layers, d_model 1024, 16 q = 16 kv heads of 64, a
plain (ungated) tanh-gelu FFN of 8192, layernorm, tied embeddings over
256,206 tokens, rope_theta 1e4.  The audio frontend is a stub, as in the
JAX package: a request carries precomputed frame embeddings (enc_seq_len,
d_model) for the encoder, and the decoder cross-attends to the encoder
memory of 4096 frames.  A copy of the JAX package's
``configs/seamless_m4t.py``."""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,               # decoder layers
    n_enc_layers=24,
    enc_seq_len=4096,          # encoder memory length for decode shapes
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    frontend="audio_frames",
    rope_theta=10_000.0,
    act="gelu",
    gated_ffn=False,
    norm="layernorm",
    tie_embeddings=True,
    max_seq_len=65_536,
    source="arXiv:2308.11596; hf tier (backbone dims; frontend stubbed per spec)",
))
