"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407]: the widest
dense decoder the port serves.  88 layers, d_model 12288, 96 query heads
over 8 kv heads of 128 (at tp=1 the head layout gives 12 q heads a kv slot:
8 slots), a gated SiLU FFN of 28672, vocab 32768, rope_theta 1e6, and an
untied LM head, (32768, 12288) beside the embedding table.  A copy of the
JAX package's ``configs/mistral_large.py``; its 245 GB of bf16 weights do
not fit one card, so the card serves it at full width and a cut depth."""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=32_768,
    rope_theta=1_000_000.0,
    act="silu",
    gated_ffn=True,
    tie_embeddings=False,
    max_seq_len=131_072,
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified tier",
))
