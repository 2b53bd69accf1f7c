"""qwen3-4b [hf:Qwen/Qwen3-4B family]: dense, 36L, d=2560, 32H (GQA kv=8),
d_ff=9728, vocab=151936, qk-norm."""

import dataclasses

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-4b",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="qwen3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab_size=128, loss_chunks=2,
    q_chunk=16)

SPEC = ArchSpec(
    arch_id="qwen3-4b", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES,
    skips={"long_500k": "pure full-attention arch: 524k dense-KV decode is "
                        "not sub-quadratic (DESIGN.md S4)"})
