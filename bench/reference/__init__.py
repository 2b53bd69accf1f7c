"""Plain PyTorch reference of the readability scores the cells check.

It imports nothing of the program.  The pair tests (occlusion, crossing,
strip reversal) are computed in the working ``dtype`` one rounding per
operation, as the configuration states them in float32, so that their
counts are exact integers to compare; sums are taken in float64 and the
per-layout scores (minimum angle, edge length variation) in float64.
``dtype=torch.bfloat16`` is the control: the same reference one
precision below.
"""
