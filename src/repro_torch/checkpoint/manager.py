"""Fault-tolerant checkpointing (counterpart of
:mod:`repro.checkpoint.manager`): atomic step checkpoints, auto-resume,
restore onto any device.

Layout, the reference's own: ``<dir>/step_<N:09d>/arrays.npz`` plus
``manifest.json`` (step, the sha256 of the payload, each key's shape and
dtype).  A tree is nested dicts (and lists or tuples) of tensors, numpy
arrays or numbers; its leaves are stored under their paths joined with
"/" (dict keys in sorted order, sequence indices as numbers), the names
the reference's ``tree_flatten_with_path`` gives, so a checkpoint
written by either package restores in the other.  Writes go to a tmp
dir and are published by one atomic ``rename``: a preempted host never
leaves a half-checkpoint that restore would trust.  Restore walks the
steps newest first and skips any whose checksum fails, so training
resumes from the newest *valid* step.

Arrays are stored unsharded (logical values) and ``restore`` puts them
on the device it is given.  Where a ``torch.distributed`` group is up,
only rank 0 writes; every rank reads.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.engine import resolve_device


def _items(tree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _flatten_with_paths(tree, prefix=""):
    """``{path: numpy array}`` of the leaves of ``tree``."""
    items = _items(tree)
    if items is None:
        if isinstance(tree, torch.Tensor):
            return {prefix: tree.detach().cpu().numpy()}
        return {prefix: np.asarray(tree)}
    out = {}
    for key, sub in items:
        out.update(_flatten_with_paths(sub, f"{prefix}/{key}" if prefix
                                       else key))
    return out


def _unflatten_like(template, arrays, leaf_fn, prefix=""):
    items = _items(template)
    if items is None:
        return leaf_fn(arrays[prefix])
    subs = {key: _unflatten_like(sub, arrays, leaf_fn,
                                 f"{prefix}/{key}" if prefix else key)
            for key, sub in items}
    if isinstance(template, dict):
        return {k: subs[str(k)] for k in template}
    return type(template)(subs[str(i)] for i in range(len(template)))


def _writes() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def save(self, step: int, tree) -> str:
        """Write ``tree`` as step ``step`` (atomically), then drop all but
        the newest ``keep`` steps.  Returns the step's directory."""
        if not _writes():
            return self._step_dir(step)
        arrays = _flatten_with_paths(tree)
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        try:
            npz_path = os.path.join(tmp, "arrays.npz")
            np.savez(npz_path, **arrays)
            with open(npz_path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest = {
                "step": step,
                "sha256": digest,
                "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                         for k, v in arrays.items()},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)              # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return self._step_dir(step)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def _valid(self, step: int) -> bool:
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            with open(os.path.join(d, "arrays.npz"), "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            return digest == manifest["sha256"]
        except (OSError, json.JSONDecodeError, KeyError):
            return False

    def latest_valid_step(self):
        for s in reversed(self.all_steps()):
            if self._valid(s):
                return s
        return None

    def restore(self, template, step: int | None = None, device=None):
        """The newest valid checkpoint (or ``step``) in the structure of
        ``template``, every leaf a tensor of the stored dtype on
        ``device`` (CUDA unless the caller passes another).  Returns
        ``(tree, step)``, or ``(None, None)`` when there is none."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_valid_step()
        if step is None:
            return None, None
        with np.load(os.path.join(self._step_dir(step),
                                  "arrays.npz")) as data:
            arrays = {k: data[k] for k in data.files}
        tree = _unflatten_like(template, arrays,
                               lambda a: torch.from_numpy(a).to(dev))
        return tree, step
