# The optimizer behind the gradient layout search (counterpart of
# repro.optim): AdamW over dicts of tensors.
