"""The paper's own workloads as dry-run cells (counterpart of
:mod:`repro.configs.readability`): readability evaluation over the six
SNAP datasets of the paper's Table 1, on the production mesh.

Shapes (soc-Epinions1, the largest, is the default dataset):

* ``exact_occlusion``   -- row-sharded O(V^2) sweep (S3.1.1);
* ``exact_crossing``    -- row-sharded O(E^2) CCW sweep (S3.1.4);
* ``enhanced_crossing`` -- strip-sharded reversal counting (S3.2.2).
"""

from repro_torch.graphs.datasets import PAPER_DATASETS

READABILITY_SHAPES = ("exact_occlusion", "exact_crossing",
                      "enhanced_crossing")
DEFAULT_DATASET = "soc-Epinions1"


def dataset_dims(name: str = DEFAULT_DATASET):
    """``(|V|, |E|)`` of a paper dataset."""
    return PAPER_DATASETS[name]
