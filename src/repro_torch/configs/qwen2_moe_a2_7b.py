"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L, d=2048, 16H (kv=16),
MoE 60 routed experts top-4 + 4 shared, expert d_ff=1408, vocab=151936."""

import dataclasses

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,                    # per-expert width (spec convention)
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    expert_d_ff=1408,
    capacity_factor=1.25,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, vocab_size=128, n_experts=8,
    n_shared_experts=1, expert_d_ff=32, moe_group=16, loss_chunks=2,
    q_chunk=16)

SPEC = ArchSpec(
    arch_id="qwen2-moe-a2.7b", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES,
    skips={"long_500k": "pure full-attention arch: 524k dense-KV decode is "
                        "not sub-quadratic (DESIGN.md S4)"})
