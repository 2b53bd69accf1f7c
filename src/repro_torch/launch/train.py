"""LM training entry point (counterpart of :mod:`repro.launch.train`): an LM
architecture trained on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --smoke --steps 50 --checkpoint-dir /tmp/ckpt [--device cpu]

What the reference's ``main`` does, on the CUDA device unless ``--device``
names another:

* auto-resume from the newest valid checkpoint;
* a checkpoint every ``--checkpoint-every`` steps (atomic, keep 3);
* the data cursor stored inside the checkpoint, so a restarted run sees
  the same batches in the same order;
* gradient accumulation (``--grad-accum``) for large global batches;
* optional int8 gradient compression (``--compress-grads``), the
  payload of a compressed data-parallel all-reduce.

The step updates the model's parameters and the optimizer state in
place (the counterpart of the reference's buffer donation): at full
width there is no room for a second copy of either.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import StreamState, TokenStream
from repro_torch.optim import adamw


def build_lm_trainer(model, opt_cfg: adamw.AdamWConfig, *,
                     grad_accum: int = 1, compress: bool = False):
    """A training step for ``model`` (a
    :class:`~repro_torch.models.transformer.Transformer`):
    ``step(opt_state, batch) -> {"loss", "grad_norm", "lr"}``.

    ``batch`` is ``{"tokens", "labels"}`` ``(B, S)`` (tensors or numpy
    arrays; moved to the model's device).  With ``grad_accum`` > 1 the
    batch is split into that many micro-batches along dim 0, their
    gradients summed in ``.grad`` and divided by ``grad_accum``, and the
    loss is their mean, as the reference's loop computes them; with
    ``compress`` the gradients go through the int8 encode and decode
    first.  The model's parameters and ``opt_state`` (from
    ``adamw.init_state(model.param_tree())``) are updated in place.

    The trainer owns the gradient buffers: it allocates every ``.grad``
    and sets ``model.stacked_grads``, so the layers' gradients add into
    the stacks' ``.grad`` in place and reach no parameter hook (a
    data-parallel step reduces those ``.grad`` itself)."""
    from repro_torch.models.transformer import loss_fn

    params = model.param_tree()
    model.stacked_grads = True
    dev = model.device

    def grads():
        return adamw._map(lambda p: p.grad, params)

    def train_step(opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        if grad_accum == 1:
            loss, _ = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
        else:
            n = batch["tokens"].shape[0] // grad_accum
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(grad_accum):
                micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                micro_loss, _ = loss_fn(model, micro)
                micro_loss.backward()
                loss = loss + micro_loss.detach()
            div = torch.full((), grad_accum, dtype=torch.float32, device=dev)
            with torch.no_grad():
                for g in adamw._leaves(grads()):
                    g.div_(div)
            loss = loss / div
        if compress:
            # int8 encode/decode models the compressed DP all-reduce
            adamw.int8_roundtrip_(grads())
        metrics = adamw.apply_updates_(params, grads(), opt_state, opt_cfg)
        return {"loss": loss, **metrics}

    return train_step


def _cursor(state: StreamState, dev):
    return {k: torch.tensor(v, dtype=torch.int32, device=dev)
            for k, v in state.cursor().items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    assert spec.family == "lm", "train.py drives the LM family"
    from repro_torch.models.transformer import Transformer
    cfg = (spec.smoke_config if args.smoke else spec.config).with_mesh(1)
    dev = resolve_device(args.device)

    opt_cfg = adamw.AdamWConfig(peak_lr=args.lr, warmup_steps=10,
                                total_steps=args.steps)
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch,
                         seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = Transformer(cfg, device=dev).init_params(gen)
    opt_state = adamw.init_state(model.param_tree())
    start_step = 0

    mgr = None
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir)
        template = {"params": model.param_tree(), "opt": opt_state,
                    "cursor": _cursor(StreamState(args.seed), dev)}
        restored, ck_step = mgr.restore(template, device=dev)
        if restored is not None:
            with torch.no_grad():
                adamw._map(lambda p, r: p.copy_(r), model.param_tree(),
                           restored["params"])
            opt_state = restored["opt"]
            stream.state = StreamState.from_cursor(
                {k: int(v) for k, v in restored["cursor"].items()})
            start_step = ck_step
            print(f"resumed from checkpoint step {ck_step}")

    step_fn = build_lm_trainer(model, opt_cfg, grad_accum=args.grad_accum,
                               compress=args.compress_grads)

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        metrics = step_fn(opt_state, stream.next_batch())
        losses.append(float(metrics["loss"]))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        if mgr and (step + 1) % args.checkpoint_every == 0:
            mgr.save(step + 1, {"params": model.param_tree(),
                                "opt": opt_state,
                                "cursor": _cursor(stream.state, dev)})
    dt = time.time() - t0
    print(f"done: {args.steps - start_step} steps in {dt:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
