"""``evaluate_exact(pos, edges, config=EvalConfig(...))`` on a fresh
layout per call, from a pool of ``pool`` layouts drawn from the seed."""

from __future__ import annotations

import types

import torch

from bench import inputs
from bench.calls import (SCORES, Phases, eval_config, ideal,
                         program_device, score_gaps)
from bench.reference import scores as ref_scores


class Call:

    def __init__(self, config, traffic, seed, device):
        self.phases = Phases()
        from repro_torch.core import metrics
        self.phases.mark("import")
        self.config, self.traffic, self.device = config, traffic, device
        self.edges, _ = inputs.make_graph(config)
        self.phases.mark("graph")
        # one layout more than the pool: the warm-up's own
        self.layouts = inputs.make_layouts(config, traffic, None,
                                           traffic["pool"] + 1, seed,
                                           device)
        self.phases.mark("layouts")
        self.metrics = metrics
        self.kw = dict(config=eval_config(config),
                       device=program_device(device))

    def warm(self):
        self.metrics.evaluate_exact(self.layouts[-1], self.edges, **self.kw)

    def __call__(self, i):
        pos = self.layouts[i % self.traffic["pool"]]
        return self.metrics.evaluate_exact(pos, self.edges, **self.kw)

    def units(self, out):
        return 1

    def release(self, outputs):
        self.metrics = None

    def _want(self, i, dtype=torch.float32):
        pos = torch.as_tensor(self.layouts[i % self.traffic["pool"]],
                              device=self.device)
        return ref_scores.exact_scores(
            pos, torch.as_tensor(self.edges, device=self.device),
            radius=self.config["eval"]["radius"], ideal=ideal(self.config),
            dtype=dtype)

    def check(self, outputs, pick):
        """Gaps of the picked calls' scores against the reference; the
        work the roofline counts, per call."""
        gaps = {f: 0 for f in SCORES}
        work = None
        for i in pick:
            want = self._want(i)
            score_gaps(gaps, outputs[i], want)
            work = want["work"]
        return gaps, work

    def control(self, dtype):
        return {0: types.SimpleNamespace(**self._want(0, dtype))}
