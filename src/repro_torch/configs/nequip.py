"""nequip [arXiv:2101.03164]: 5 layers, 32 channels, l_max=2, 8 RBF,
cutoff 5 A, E(3)-equivariant tensor products (counterpart of
:mod:`repro.configs.nequip`)."""

import dataclasses

from repro_torch.configs import ArchSpec, GNN_SHAPES
from repro_torch.models.equivariant import NequIPConfig

CONFIG = NequIPConfig(
    name="nequip",
    n_layers=5,
    d_hidden=32,
    l_max=2,
    n_rbf=8,
    cutoff=5.0,
)

SMOKE_CONFIG = dataclasses.replace(CONFIG, name="nequip-smoke", n_layers=2,
                                   d_hidden=8, edge_chunk=128)

SPEC = ArchSpec(arch_id="nequip", family="gnn", config=CONFIG,
                smoke_config=SMOKE_CONFIG, shapes=GNN_SHAPES, skips={})
