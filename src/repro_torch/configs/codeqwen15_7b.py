"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: dense, 32L, d=4096, 32H
(GQA kv=32, i.e. MHA-width KV), d_ff=13440, vocab=92416, qkv bias
(qwen1.5 family)."""

import dataclasses

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="codeqwen1.5-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="codeqwen1.5-7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab_size=128, loss_chunks=2,
    q_chunk=16)

SPEC = ArchSpec(
    arch_id="codeqwen1.5-7b", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES,
    skips={"long_500k": "pure full-attention arch: 524k dense-KV decode is "
                        "not sub-quadratic (DESIGN.md S4)"})
