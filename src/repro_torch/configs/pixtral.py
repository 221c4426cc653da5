"""pixtral-12b [hf:mistralai/Pixtral-12B-2409]: a mistral-nemo-like decoder
(40 layers, d_model 5120, 32 q over 8 kv heads of 128, d_ff 14336, vocab
131072, an untied LM head) behind a pixtral-ViT frontend stub that splices
1024 precomputed patch embeddings into the token sequence.  A copy of the
JAX package's ``configs/pixtral.py``.  Registered, not served: the
serving engines take token-only prompts, and the frontend's image embeds
would need injection at prefill (``core.model.check_supported`` refuses it
as the JAX paged engine does)."""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    frontend="vision_patches",
    n_frontend_embeds=1024,
    rope_theta=1_000_000.0,
    act="silu",
    gated_ffn=True,
    tie_embeddings=False,
    max_seq_len=131_072,
    source="hf:mistralai/Pixtral-12B-2409; unverified tier (backbone only)",
))
