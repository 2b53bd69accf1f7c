"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden=16, mean aggregation,
symmetric normalization. d_in / n_classes vary by graph shape (the GCN
paper's config is hidden width + depth)."""

import dataclasses

from repro_torch.configs import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="gcn-cora",
    kind="gcn",
    n_layers=2,
    d_in=1433,                   # cora; overridden per shape
    d_hidden=16,
    n_classes=7,
    aggregator="mean",
    norm="sym",
)

SMOKE_CONFIG = dataclasses.replace(CONFIG, name="gcn-cora-smoke", d_in=12,
                                   d_hidden=8, n_classes=3)

SPEC = ArchSpec(arch_id="gcn-cora", family="gnn", config=CONFIG,
                smoke_config=SMOKE_CONFIG, shapes=GNN_SHAPES, skips={})
