"""The paper's own decoder, TinyLlama-42M [llama2.c / paper V-A]: E=512,
intermediate 2048, 8 layers, 8 heads, vocab 32000.  The attention
decoder the paged-serving slices of the port serve."""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="tinyllama-42m",
    family="dense",
    n_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=32_000,
    rope_theta=10_000.0,
    act="silu",
    gated_ffn=True,
    tie_embeddings=True,
    max_seq_len=1024,
    source="paper §V-A / karpathy llama2.c",
))
