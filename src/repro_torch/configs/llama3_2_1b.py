"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256, tied embeddings. [hf:meta-llama/Llama-3.2-1B; unverified]

The same numbers as ``repro.configs.llama3_2_1b``: the reference's first
dense serving model, whose prefill runs the flash-attention kernel in every
layer.
"""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, vocab=128256,
    n_heads=32, n_kv_heads=8, d_ff=8192, head_dim=64,
    tie_embeddings=True, rope_theta=5e5,
)

SMOKE = ModelConfig(
    name="llama3.2-smoke", family="dense",
    n_layers=2, d_model=64, vocab=256,
    n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16,
    tie_embeddings=True, dtype=torch.float32,
)
