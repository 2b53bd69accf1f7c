"""graphsage-reddit [arXiv:1706.02216]: 2 layers, d_hidden=128, mean
aggregator, sample sizes 25-10 (training fanout per the paper; the
``minibatch_lg`` shape overrides fanout to 15-10 per the shape spec)."""

import dataclasses

from repro_torch.configs import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="graphsage-reddit",
    kind="graphsage",
    n_layers=2,
    d_in=602,                    # reddit; overridden per shape
    d_hidden=128,
    n_classes=41,
    aggregator="mean",
    sample_sizes=(25, 10),
)

SMOKE_CONFIG = dataclasses.replace(CONFIG, name="graphsage-smoke", d_in=12,
                                   d_hidden=8, n_classes=3,
                                   sample_sizes=(5, 3))

SPEC = ArchSpec(arch_id="graphsage-reddit", family="gnn", config=CONFIG,
                smoke_config=SMOKE_CONFIG, shapes=GNN_SHAPES, skips={})
