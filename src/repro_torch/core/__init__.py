# Readability metrics and the plan-once/evaluate-many engine, as PyTorch
# ops (counterpart of repro.core): five metrics, exact (all-pairs) and
# enhanced (grid/strip) algorithms.
#
# The public front door is repro_torch.api (EvalConfig + Evaluator ->
# ReadabilityScores); the names below are the building blocks it is made
# of, plus the deprecated evaluate_layout shim.  They are resolved on
# first access: the kernel modules import repro_torch.core.geometry, so
# importing the whole core here would be circular.
import importlib

_EXPORTS = {
    "crossing": ("count_crossings_enhanced", "count_crossings_exact",
                 "count_crossings_strips"),
    "crossing_angle": ("crossing_angle_enhanced", "crossing_angle_exact",
                       "crossing_angle_strips"),
    "edge_length": ("edge_length_variation",),
    "engine": ("EngineResult", "ReadabilityPlan", "evaluate_layouts",
               "evaluate_once", "evaluate_planned", "plan_readability",
               "replan_on_overflow"),
    "incremental": ("ResidentState", "ResidentStrip", "delta_probe",
                    "evaluate_delta", "prime_state"),
    "keys": ("EvalConfig", "pow2_bucket", "topology_hash"),
    "metrics": ("ALL_METRICS", "ReadabilityReport", "evaluate_exact",
                "evaluate_layout", "report_from_result",
                "reports_from_batch"),
    "min_angle": ("minimum_angle",),
    "occlusion": ("count_occlusions_enhanced", "count_occlusions_exact",
                  "count_occlusions_gridded"),
    "scores": ("ReadabilityScores", "scores_from_batch",
               "scores_from_result"),
}
_HOME = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_HOME)


def __getattr__(name):
    mod = _HOME.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
