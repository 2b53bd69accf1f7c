"""internlm2-20b [arXiv:2403.17297]: dense, 48L, d=6144, 48H (GQA kv=8),
d_ff=16384, vocab=92544."""

import dataclasses

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="internlm2-20b",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1e6,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="internlm2-20b-smoke", n_layers=2, d_model=64, n_heads=8,
    n_kv_heads=2, d_head=8, d_ff=128, vocab_size=128, loss_chunks=2,
    q_chunk=16)

SPEC = ArchSpec(
    arch_id="internlm2-20b", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES,
    skips={"long_500k": "pure full-attention arch: 524k dense-KV decode is "
                        "not sub-quadratic (DESIGN.md S4)"})
