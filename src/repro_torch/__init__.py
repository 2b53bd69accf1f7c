"""PyTorch port of the readability evaluator (:mod:`repro` is the JAX
reference it is held against).

The public front door is :mod:`repro_torch.api` (``EvalConfig`` +
``Evaluator`` -> ``ReadabilityScores``).  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; on a CUDA tensor the
strip-reversal and occlusion-pair sweeps launch hand-written kernels
(:mod:`repro_torch.kernels`), on a CPU tensor their plain PyTorch
versions run instead.
"""
