"""Uniform random layouts in ``[0, scale)^2`` (the paper's random
layouts, S4.1); ``scale`` from the configuration's ``layouts``."""

import torch


def make(config, traffic, base, n_layouts, gen):
    n_v = config["graph"]["n_vertices"]
    return torch.rand((n_layouts, n_v, 2), generator=gen, device=gen.device,
                      dtype=torch.float32) * float(config["layouts"]["scale"])
