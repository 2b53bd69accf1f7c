"""llama4-scout-17b-a16e [meta-llama/Llama-4-Scout-17B-16E; unverified]:
48L, d=5120, 40H (GQA kv=8), MoE 16 routed top-1 + 1 shared, expert
d_ff=8192, vocab=202048, iRoPE: chunked-local attention (8192) with every
4th layer global + NoPE.

Runs ``long_500k``: local layers are sub-quadratic (8k chunks); global
layers decode against a sequence-sharded KV cache with softmax-merge
collectives (DESIGN.md S4)."""

import dataclasses

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,                  # padded to 48 on a 16-way model axis
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,                   # per-expert width
    vocab_size=202048,
    rope_theta=5e5,
    n_experts=16,
    n_shared_experts=1,
    top_k=1,
    expert_d_ff=8192,
    capacity_factor=1.25,
    attn_chunk=8192,
    global_interval=4,
    nope_on_global=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="llama4-scout-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, vocab_size=128, n_experts=4,
    n_shared_experts=1, expert_d_ff=32, moe_group=16, attn_chunk=8,
    global_interval=2, loss_chunks=2, q_chunk=16)

SPEC = ArchSpec(
    arch_id="llama4-scout-17b-a16e", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES, skips={})
