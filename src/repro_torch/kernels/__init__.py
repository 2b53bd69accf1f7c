# Hand-written CUDA kernels for Hopper (sm_90a) with their plain PyTorch
# versions, launch counters and the nvcc build (kernels/_build.py).
