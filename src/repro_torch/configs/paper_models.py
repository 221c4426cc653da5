"""The paper's own workloads: TinyLlama-42M (decoder) and MobileBERT
(encoder).  A copy of the JAX package's ``configs/paper_models.py``.

TinyLlama-42M [llama2.c / paper V-A]: E=512, intermediate 2048, 8 layers,
8 heads, vocab 32000; S=128 autoregressive / S=16 prompt.  The scaled-up
variant for the Fig. 6 scalability study has 64 heads of head_dim 8, other
dims unchanged; the port serves both.

MobileBERT [paper V-A]: encoder-only, E=512, intermediate 512, 4 heads,
S=268.  (The released MobileBERT's bottleneck structure is simplified to a
standard encoder block with the paper's stated dims; the sim's workload
model uses the same dims so repro numbers are self-consistent.)  Registered
for the sim (``repro_torch.sim``), not served: an encoder has no decode
path (``core.model.check_supported`` refuses it as the JAX engines do).
"""
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

register(ModelConfig(
    name="tinyllama-42m-64h",          # Fig. 6 scalability variant
    family="dense",
    n_layers=8,
    d_model=512,
    n_heads=64,
    n_kv_heads=64,
    head_dim=8,
    d_ff=2048,
    vocab_size=32_000,
    rope_theta=10_000.0,
    act="silu",
    gated_ffn=True,
    tie_embeddings=True,
    max_seq_len=1024,
    source="paper §V-C (64-head scalability study)",
))

register(ModelConfig(
    name="mobilebert",
    family="encoder",
    n_layers=24,
    d_model=512,
    n_heads=4,
    n_kv_heads=4,
    head_dim=128,
    d_ff=512,
    vocab_size=30_522,
    causal=False,
    rope_theta=10_000.0,
    act="gelu",
    gated_ffn=False,
    norm="layernorm",
    tie_embeddings=True,
    max_seq_len=512,
    source="paper §V-A (MobileBERT dims)",
))
