"""Architecture registry (counterpart of :mod:`repro.configs`): each
architecture's published config, a reduced smoke config and its shape
set.

``get_arch(arch_id)`` -> :class:`ArchSpec`; ``list_archs()`` -> ids.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Mapping, Sequence

ARCH_IDS = (
    "codeqwen1.5-7b",
    "internlm2-20b",
    "qwen3-4b",
    "qwen2-moe-a2.7b",
    "llama4-scout-17b-a16e",
    "gcn-cora",
    "nequip",
    "equiformer-v2",
    "graphsage-reddit",
    "xdeepfm",
)

_MODULES = {
    "codeqwen1.5-7b": "codeqwen15_7b",
    "internlm2-20b": "internlm2_20b",
    "qwen3-4b": "qwen3_4b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "gcn-cora": "gcn_cora",
    "nequip": "nequip",
    "equiformer-v2": "equiformer_v2",
    "graphsage-reddit": "graphsage_reddit",
    "xdeepfm": "xdeepfm",
}

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                   # 'lm' | 'gnn' | 'recsys'
    config: Any
    smoke_config: Any
    shapes: Sequence[str]
    # shape_id -> skip reason (cells the paper pool marks inapplicable)
    skips: Mapping[str, str] = dataclasses.field(default_factory=dict)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCH_IDS:
        raise KeyError(arch_id)
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch_id]}").SPEC


def list_archs():
    return list(ARCH_IDS)


def all_cells(include_skipped: bool = False):
    """Every (arch, shape, skip reason) cell."""
    cells = []
    for arch_id in ARCH_IDS:
        spec = get_arch(arch_id)
        for shape in spec.shapes:
            reason = spec.skips.get(shape)
            if reason is None or include_skipped:
                cells.append((arch_id, shape, reason))
    return cells
