"""Layout generation driven by the readability engine (counterpart of
:mod:`repro.search`): :class:`~repro_torch.search.gradient.GradientSearch`
descends the differentiable relaxations of :mod:`repro_torch.core.soft`
with AdamW, B restarts per step, and reports exact re-scores only."""

from repro_torch.search.gradient import (GradientSearch, SearchResult,
                                         batch_objectives)

__all__ = ["GradientSearch", "SearchResult", "batch_objectives"]
