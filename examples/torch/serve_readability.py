"""Serve batched readability-evaluation requests on the PyTorch port, as
``examples/serve_readability.py`` does with the JAX package: one
EvalConfig drives the plan-cached, shape-bucketed, request-coalescing
session server; round 2 of the stream is the steady state (zero
replans: see the printed stats).

Runs on the CUDA device; pass ``--device cpu`` to run it on the CPU.

  PYTHONPATH=src python examples/torch/serve_readability.py [--device cpu]

Try a metric-subset service: ``--metrics edge_crossing,edge_crossing_angle``.
"""

import sys

from repro_torch.launch.serve import main as serve_main

# defaults first; anything on the command line overrides them
serve_main(["--requests", "6", "--rounds", "2", "--backend", "fused"]
           + sys.argv[1:])
