"""Candidates around the graph's own layout: N(0, ``sigma``) added to
each coordinate, ``sigma`` from the traffic file."""

import torch


def make(config, traffic, base, n_layouts, gen):
    b = torch.as_tensor(base, device=gen.device)
    return b + float(traffic["sigma"]) * torch.randn(
        (n_layouts,) + tuple(b.shape), generator=gen, device=gen.device,
        dtype=torch.float32)
