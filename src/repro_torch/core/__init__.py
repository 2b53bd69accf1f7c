# Readability metrics and the plan-once/evaluate-many engine, as PyTorch
# ops (counterpart of repro.core).
