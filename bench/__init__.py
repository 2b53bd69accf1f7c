"""The benchmark of the PyTorch port ``repro_torch``: one cell of
``BENCHMARK.json`` per run of ``python3 bench/run.py``."""
