"""``Evaluator(EvalConfig(...)).search(pos0, edges, **knobs)`` from the
graph's own layout, with a fresh search seed per call drawn from the
run's seed.

The search is made as ``Evaluator.search`` makes it, by a subclass of
``GradientSearch`` that also keeps a copy of what each step returns
(positions, both moments, losses, gradient norm) for one call of the
window, drawn from the seed as the window runs (a reservoir sample, so
that one call's record at a time is held on the device).  The check
recomputes that call's first step from the restart batch and its last
step from the state the step before it left, and holds every step to
AdamW's rule (see :meth:`Call.check`).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from bench.calls import (SCORES, Phases, eval_config, finite, ideal,
                         program_device, score_gaps)
from bench import inputs
from bench.reference import scores as ref_scores
from bench.reference import soft as ref_soft

STEP_GAPS = ("start", "loss", "grad_norm", "grad", "update", "last.loss",
             "last.grad", "last.v", "last.update", "steps.update",
             "steps.moments")


def _rel(a, b):
    """``|a - b| / |b|``, elementwise maximum (infinite where not
    finite)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return finite(float(np.max(np.abs(a - b) / np.abs(b))))


def _norm_gap(got, want, scale):
    """``||got - want|| / ||scale||`` (infinite where not finite)."""
    got, want, scale = (torch.as_tensor(t).double()
                        for t in (got, want, scale))
    return finite(float((got - want).norm() / scale.norm()))


def _median_gap(got, want, scale):
    """The median over the restarts (the leading axis) of each restart's
    ``||got - want|| / ||scale||`` (infinite where not finite).  Float32
    rounding at a few vertices of one restart can swing a norm over the
    whole batch from seed to seed; a fault of every restart, or of half
    of them, moves the median."""
    got, want, scale = (torch.as_tensor(t).double().flatten(1)
                        for t in (got, want, scale))
    per = (got - want).norm(dim=1) / scale.norm(dim=1)
    return finite(float(np.median(per.numpy())))


class Call:

    def __init__(self, config, traffic, seed, device):
        self.phases = Phases()
        from repro_torch.api import Evaluator
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.search.gradient import GradientSearch
        self.phases.mark("import")
        if traffic["rescore_every"] < traffic["steps"]:
            raise ValueError("the check recomputes steps under the plan "
                             "of the restart batch: rescore_every must be "
                             "at least steps")
        self.config, self.traffic, self.device = config, traffic, device
        self.edges, self.base = inputs.make_graph(config)
        self.phases.mark("graph")
        # one search seed per call of the pool, and the warm-up's own
        self.seeds = np.random.default_rng([seed % (1 << 63), 3]).integers(
            0, 1 << 62, size=traffic["pool"] + 1).tolist()
        self.evaluator = Evaluator(eval_config(config),
                                   device=program_device(device))
        self.knobs = dict(
            steps=traffic["steps"], restarts=traffic["restarts"],
            rescore_every=traffic["rescore_every"], jitter=traffic["jitter"],
            temperature=traffic["temperature"],
            final_temperature=traffic["final_temperature"],
            opt=AdamWConfig(**traffic["opt"]))
        self._reservoir = np.random.default_rng([seed % (1 << 63), 7, 1])
        self.kept = None        # (call index, its steps' records)
        records = self._records = []
        on = self._recording = [False]

        class Recorded(GradientSearch):
            def step(self, *args, **kwargs):
                out = super().step(*args, **kwargs)
                if on[0]:
                    new, state, losses, grad_norm = out
                    records.append(dict(
                        pos=new.detach().clone(),
                        m=state["m"]["pos"].clone(),
                        v=state["v"]["pos"].clone(),
                        losses=losses.clone(), grad_norm=grad_norm.clone()))
                return out
        self.search_cls = Recorded

    def _search(self, seed, record):
        self._records.clear()
        self._recording[0] = record
        ev = self.evaluator
        return self.search_cls(ev.config, device=ev.device, mesh=ev.mesh,
                               seed=seed, **self.knobs).run(self.base,
                                                            self.edges)

    def warm(self):
        self._search(self.seeds[-1], record=True)
        self._records.clear()

    def __call__(self, i):
        # the i-th call takes the kept one's place with chance 1 / (i + 1)
        keep = self._reservoir.random() * (i + 1) < 1.0
        out = self._search(self.seeds[i % self.traffic["pool"]], keep)
        if keep:
            self.kept = (i, list(self._records))
        self._records.clear()
        return out

    def units(self, out):
        return self.traffic["steps"]

    def pick(self, done, rng):
        if self.kept is None or self.kept[0] not in done:
            raise ValueError("no call of the window kept its steps")
        return [self.kept[0]]

    def release(self, outputs):
        """Frees the program's state, the kept steps moved to the host
        first."""
        if self.kept is not None:
            i, recs = self.kept
            self.kept = (i, [{k: torch.as_tensor(v).cpu()
                              for k, v in r.items()} for r in recs])
        self._records.clear()
        self.evaluator = self.search_cls = None

    def _common(self):
        ev = self.config["eval"]
        return dict(radius=ev["radius"], n_strips=ev["n_strips"],
                    ideal=ideal(self.config), device=self.device)

    def _batch(self, i):
        tr = self.traffic
        return ref_soft.restart_batch(self.base, tr["restarts"],
                                      tr["jitter"],
                                      self.seeds[i % tr["pool"]])

    def check(self, outputs, pick):
        """Gaps of the picked call:

        * ``start``: its restart batch against the reference's (exact);
        * the score fields: the exact scores it reports for its starts
          and its results against the reference's scores of those
          layouts;
        * ``loss``, ``grad_norm``, ``grad``, ``update``: its first step,
          recomputed from the restart batch (losses and pre-clip norm
          relative, the clipped gradient as the first moment gives it by
          the norm of the difference, the update by the gap of norms);
        * ``last.*``: its last step, recomputed from the positions and
          moments the step before it left, with the step's own index,
          temperature and learning rate: losses and gradient as above, the second moment by the norm of the
          difference over its increment, the new positions by the norm
          of the difference over the update;
        * ``steps.update``: every step's new positions against AdamW's
          rule applied to the step's own moments, with the index's
          learning rate and bias corrections (norm of the difference
          over the update, the widest step);
        * ``steps.moments``: every step's two moments against each
          other: the gradient's square sum that ``v`` gained against
          that of the gradient ``m`` gained (relative, the widest
          step)."""
        tr, opt = self.traffic, self.traffic["opt"]
        b1, b2 = opt["b1"], opt["b2"]
        common = self._common()
        gaps = {f: 0 for f in SCORES}
        gaps.update({k: 0.0 for k in STEP_GAPS})
        edges = torch.as_tensor(self.edges, device=self.device)
        ev = self.config["eval"]
        for i in pick:
            res = outputs[i]
            if self.kept is None or self.kept[0] != i:
                raise ValueError(f"call {i} kept no steps")
            recs = self.kept[1]
            if len(recs) != tr["steps"]:
                raise ValueError(f"call {i} ran {len(recs)} steps; the "
                                 f"traffic asks for {tr['steps']}")
            batch = self._batch(i)
            gaps["start"] = max(gaps["start"], float(np.abs(
                np.asarray(res.init_positions) - batch).max()))
            for layouts, got in ((res.init_positions, res.init_scores),
                                 (res.positions, res.scores)):
                for b in range(len(got)):
                    want = ref_scores.enhanced_scores(
                        torch.as_tensor(np.asarray(layouts[b]),
                                        device=self.device), edges,
                        radius=ev["radius"], n_strips=ev["n_strips"],
                        ideal=common["ideal"])
                    score_gaps(gaps, got[b], want)
            zero = torch.zeros(batch.shape, dtype=torch.float64)
            states = [dict(pos=torch.as_tensor(batch), m=zero, v=zero)] + [
                {k: torch.as_tensor(r[k]).double() for k in ("pos", "m",
                                                             "v")}
                for r in recs]
            grid = ref_soft.occlusion_grid(batch, ev["radius"])
            for prefix, k in (("", 1), ("last.", tr["steps"])):
                prev, got, rec = states[k - 1], states[k], recs[k - 1]
                ref = ref_soft.step(prev["pos"], prev["m"], prev["v"], k,
                                    self.edges, grid, traffic=tr, **common)
                g_got = (got["m"] - b1 * prev["m"]) / (1 - b1)
                new = {
                    "loss": _rel(torch.as_tensor(rec["losses"]).double(),
                                 ref["losses"]),
                    "grad": _median_gap(g_got, ref["g"], ref["g"])}
                if prefix:
                    new["v"] = _median_gap(got["v"], ref["v"],
                                           (1 - b2) * ref["g"] ** 2)
                    new["update"] = _median_gap(
                        got["pos"], ref["new_pos"],
                        ref["new_pos"] - prev["pos"])
                else:
                    new["grad_norm"] = _rel(float(rec["grad_norm"]),
                                            ref["grad_norm"])
                    d_got = (got["pos"] - prev["pos"]).norm()
                    d_ref = (ref["new_pos"] - prev["pos"]).norm()
                    new["update"] = finite(float(abs(d_got - d_ref)
                                                 / d_ref))
                for name, value in new.items():
                    gaps[prefix + name] = max(gaps[prefix + name], value)
            for k in range(1, len(states)):
                prev, got = states[k - 1], states[k]
                want = ref_soft.apply_moments(prev["pos"], got["m"],
                                              got["v"], k, opt)
                gaps["steps.update"] = max(gaps["steps.update"], _norm_gap(
                    got["pos"], want, want - prev["pos"]))
                g2_m = (((got["m"] - b1 * prev["m"]) / (1 - b1)) ** 2).sum()
                g2_v = ((got["v"] - b2 * prev["v"]) / (1 - b2)).sum()
                gaps["steps.moments"] = max(gaps["steps.moments"], _rel(
                    float(g2_v), float(g2_m)))
        return gaps, None

    def control(self, dtype):
        """The reference's whole search in ``dtype`` from the first
        call's restart batch, its start and its last positions scored in
        ``dtype``, as the program's outputs of call 0."""
        common = self._common()
        batch = self._batch(0)
        recs = ref_soft.search_steps(batch, self.edges, traffic=self.traffic,
                                     dtype=dtype, **common)
        edges = torch.as_tensor(self.edges, device=self.device)
        ev = self.config["eval"]

        def scored(layouts):
            return [types.SimpleNamespace(**ref_scores.enhanced_scores(
                torch.as_tensor(np.asarray(p), device=self.device), edges,
                radius=ev["radius"], n_strips=ev["n_strips"],
                ideal=common["ideal"], dtype=dtype)) for p in layouts]
        last = recs[-1]["pos"].numpy()
        result = types.SimpleNamespace(
            init_positions=batch, init_scores=scored(batch),
            positions=last, scores=scored(last))
        self.kept = (0, recs)
        return {0: result}
