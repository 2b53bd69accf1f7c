"""Train a reduced LM for a few hundred steps with fault-tolerant
checkpointing on the PyTorch port, as ``examples/train_lm.py`` does with
the JAX package (kill it mid-run and re-launch: it resumes).

Runs on the CUDA device; ``--device cpu`` runs it on the CPU.

  PYTHONPATH=src python examples/torch/train_lm.py [--device cpu]
"""

import argparse
import tempfile

from repro_torch.launch.train import main as train_main

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: CUDA)")
args = ap.parse_args()

ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_lm_ckpt_")
print(f"checkpoints -> {ckpt_dir}")

losses = train_main([
    "--arch", "qwen3-4b", "--smoke",
    "--steps", "200",
    "--batch", "8",
    "--seq", "64",
    "--lr", "3e-3",
    "--checkpoint-dir", ckpt_dir,
    "--checkpoint-every", "50",
] + (["--device", args.device] if args.device else []))

assert losses[-1] < losses[0], "loss did not decrease"
print(f"loss decreased {losses[0]:.3f} -> {losses[-1]:.3f} over "
      f"{len(losses)} steps")
