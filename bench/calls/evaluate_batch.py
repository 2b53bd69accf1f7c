"""``Evaluator(EvalConfig(...)).evaluate_batch(batch, edges, plan=plan)``:
``batch`` candidates jittered around the graph's layout, from a pool of
``pool`` batches drawn from the seed, under one plan made in set-up over
every layout of the pool."""

from __future__ import annotations

import types

import numpy as np
import torch

from bench import inputs
from bench.calls import (SCORES, Phases, eval_config, ideal,
                         program_device, score_gaps)
from bench.metrics import _work
from bench.reference import scores as ref_scores


class Call:

    def __init__(self, config, traffic, seed, device):
        self.phases = Phases()
        from repro_torch.api import Evaluator
        self.phases.mark("import")
        self.config, self.traffic, self.device = config, traffic, device
        self.edges, base = inputs.make_graph(config)
        self.phases.mark("graph")
        B, P = traffic["batch"], traffic["pool"]
        lay = inputs.make_layouts(config, traffic, base, B * P, seed,
                                  device)
        self.batches = lay.reshape(P, B, *lay.shape[1:])
        self.phases.mark("layouts")
        self.evaluator = Evaluator(eval_config(config),
                                   device=program_device(device))
        self.plan = self.evaluator.plan(lay, self.edges)
        self.phases.mark("plan")

    def warm(self):
        for b in self.batches[:2]:
            self.evaluator.evaluate_batch(b, self.edges, plan=self.plan)

    def __call__(self, i):
        return self.evaluator.evaluate_batch(
            self.batches[i % self.traffic["pool"]], self.edges,
            plan=self.plan)

    def units(self, out):
        return self.traffic["batch"]

    def release(self, outputs):
        self.evaluator = self.plan = None

    def _members(self, i, dtype=torch.float32):
        edges = torch.as_tensor(self.edges, device=self.device)
        ev = self.config["eval"]
        for m in self.batches[i % self.traffic["pool"]]:
            pos = torch.as_tensor(m, device=self.device)
            want = ref_scores.enhanced_scores(
                pos, edges, radius=ev["radius"], n_strips=ev["n_strips"],
                ideal=ideal(self.config), dtype=dtype)
            yield pos, want

    def check(self, outputs, pick):
        """Gaps of every member of the picked calls against the
        reference (the widest over the members); the work per call."""
        gaps = {f: 0 for f in SCORES}
        work = None
        for i in pick:
            total = {}
            for m, (pos, want) in enumerate(self._members(i)):
                score_gaps(gaps, outputs[i], want, index=m)
                want["work"]["cell_pairs"] = _work.cell_pairs(
                    pos, self.config["eval"]["radius"])
                for k, v in want["work"].items():
                    total[k] = total.get(k, 0) + v
            work = total
        return gaps, work

    def control(self, dtype):
        members = [want for _, want in self._members(0, dtype)]
        return {0: types.SimpleNamespace(**{
            f: np.array([m[f] for m in members]) for f in SCORES})}
