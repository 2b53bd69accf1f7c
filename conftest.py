"""Settings shared by the tests under ``tests/`` and ``bench/``.

Torch runs its host ops on one intra-op thread.  The suite runs in
several worker processes at once (``pytest -n 6``), and torch's default
of one thread per core in each of them oversubscribes the host: on an
8-core host the whole suite took 1720 s with the default and 1113 s
with one thread, with the same tests passing and failing.  The
benchmark's own runs use one thread too (``bench/run.py``).
"""

import torch

torch.set_num_threads(1)
