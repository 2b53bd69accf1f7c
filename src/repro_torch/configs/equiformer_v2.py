"""equiformer-v2 [arXiv:2306.12059; unverified]: 12 layers, 128 channels,
l_max=6, m_max=2, 8 heads, SO(2)-eSCN convolutions (counterpart of
:mod:`repro.configs.equiformer_v2`)."""

import dataclasses

from repro_torch.configs import ArchSpec, GNN_SHAPES
from repro_torch.models.equivariant import EquiformerConfig

CONFIG = EquiformerConfig(
    name="equiformer-v2",
    n_layers=12,
    d_hidden=128,
    l_max=6,
    m_max=2,
    n_heads=8,
)

SMOKE_CONFIG = dataclasses.replace(CONFIG, name="equiformer-v2-smoke",
                                   n_layers=2, d_hidden=16, l_max=3,
                                   n_heads=4, edge_chunk=128)

SPEC = ArchSpec(arch_id="equiformer-v2", family="gnn", config=CONFIG,
                smoke_config=SMOKE_CONFIG, shapes=GNN_SHAPES, skips={})
