"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim=10, CIN
200-200-200, MLP 400-400. Heavy-tailed per-field vocabularies
(Criteo-like; ~91M total rows), all multiples of 16 so the concatenated
table row-shards evenly over the model axis."""

import dataclasses

from repro_torch.configs import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import XDeepFMConfig

# 3 huge + 6 large + 10 medium + 20 small = 39 fields, ~91M rows
FIELD_VOCABS = tuple([20_000_000] * 3 + [5_000_000] * 6 + [100_000] * 10
                     + [1_008] * 20)

CONFIG = XDeepFMConfig(
    name="xdeepfm",
    field_vocabs=FIELD_VOCABS,
    embed_dim=10,
    cin_layers=(200, 200, 200),
    mlp_dims=(400, 400),
    retrieval_dim=128,
    n_items=1_000_000,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="xdeepfm-smoke", field_vocabs=tuple([64] * 6),
    embed_dim=4, cin_layers=(8, 8), mlp_dims=(16, 16), retrieval_dim=8,
    n_items=256)

SPEC = ArchSpec(arch_id="xdeepfm", family="recsys", config=CONFIG,
                smoke_config=SMOKE_CONFIG, shapes=RECSYS_SHAPES, skips={})
