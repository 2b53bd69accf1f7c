"""Gradient-guided layout search over the differentiable engine
(counterpart of :mod:`repro.search.gradient`).

:class:`GradientSearch` descends the summed per-restart
:func:`repro_torch.core.soft.soft_loss` of a ``(B, V, 2)`` restart batch
with AdamW (:mod:`repro_torch.optim.adamw`).  One step is one forward and
backward (``torch.autograd.grad`` on a leaf ``pos``) and one
``apply_updates`` under ``torch.no_grad()``; the host waits on the device
only at the exact re-scores.

**Exact numbers are the reported numbers**: every ``rescore_every`` steps
the restarts are re-scored by the exact engine
(:func:`repro_torch.core.engine.evaluate_layouts`, which on CUDA launches
the strip-reversal kernel), best-so-far candidates are tracked by the mean
of :meth:`ReadabilityScores.normalized` fields, and :class:`SearchResult`
carries only exact scores.

Temperature anneals geometrically from ``EvalConfig.temperature`` (or the
``temperature`` override) to ``final_temperature``, as a 0-d tensor per
step.  Restart jitter comes from numpy ``default_rng(seed)``, so the
starts are the reference's.  Inputs go through the port's
``validate_batch``; V=0 is rejected; E=0 is padded to one masked edge row.

Runs on the CUDA device unless ``device`` says otherwise.  On CUDA the
backward's gathers accumulate with atomics, so two searches there need
not take bit-identical trajectories; their reported scores are exact
scores of the returned layouts all the same.

``backend="distributed"`` splits each step's restarts over a mesh
(``mesh=``, or the serving policy's): every rank runs the forward and
backward of its rows, the ranks ``all_gather`` the gradients and losses,
and every rank applies the same AdamW update to the global arrays; the
exact re-scores go through
:func:`repro_torch.distributed.batched.evaluate_layouts_sharded`.  The
restart count is padded up to a multiple of the mesh size with extra
jittered starts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine, soft
from repro_torch.core.keys import EvalConfig
from repro_torch.core.scores import ReadabilityScores, host_batch
from repro_torch.core.validate import InvalidInputError, validate_batch
from repro_torch.optim import adamw
from repro_torch.spans import span

# The five normalized metric fields that enter the search objective
# (crossing_count_for_angle is E_ca's paired count, not a readability).
OBJECTIVE_FIELDS = ("node_occlusion", "minimum_angle",
                    "edge_length_variation", "edge_crossing",
                    "edge_crossing_angle")


def batch_objectives(batch_scores: ReadabilityScores) -> np.ndarray:
    """Scalar objective per layout: the mean of the normalized metric
    fields present (higher is better, in [0, 1]) -- what
    :func:`~repro_torch.core.soft.soft_loss` descends with unit weights,
    up to the relaxation."""
    norm = batch_scores.normalized()
    vals = [np.asarray(getattr(norm, f), np.float64)
            for f in OBJECTIVE_FIELDS if getattr(norm, f) is not None]
    if not vals:
        raise ValueError("no metric fields present to rank by")
    return np.mean(np.stack(vals), axis=0)


class SearchResult(NamedTuple):
    """Outcome of a :class:`GradientSearch` run.

    All scores are exact engine scores (host :class:`ReadabilityScores`);
    ``positions`` / ``scores`` / ``objectives`` describe the best-so-far
    layout of each restart, selected by exact re-scoring.
    ``trajectory`` has one record per exact re-score (step, temperature,
    mean soft loss, mean / best exact objective); ``counters`` counts
    re-scores and replans."""

    positions: np.ndarray        # (B, V, 2) best-so-far per restart
    scores: tuple                # B host ReadabilityScores (exact)
    objectives: np.ndarray       # (B,) normalized objective per restart
    init_positions: np.ndarray   # (B, V, 2) the starting restarts
    init_scores: tuple           # B host ReadabilityScores of the starts
    init_objectives: np.ndarray  # (B,)
    trajectory: tuple            # per-rescore records (dicts)
    steps: int
    restarts: int
    counters: dict

    @property
    def best_index(self) -> int:
        return int(np.argmax(self.objectives))

    @property
    def best_positions(self) -> np.ndarray:
        return self.positions[self.best_index]

    @property
    def best_scores(self) -> ReadabilityScores:
        return self.scores[self.best_index]

    @property
    def best_objective(self) -> float:
        return float(self.objectives[self.best_index])

    @property
    def improvement(self) -> float:
        """Best final objective minus the best initial objective."""
        return self.best_objective - float(np.max(self.init_objectives))


class GradientSearch:
    """Gradient-guided readability search: B restarts per step.

    ``config`` gives the plan geometry, metric subset, validation mode
    and starting ``temperature``; ``steps``, ``restarts`` and
    ``rescore_every`` the run's length, restart count and exact
    re-scoring cadence (a final re-score always happens).  ``opt`` is an
    :class:`~repro_torch.optim.adamw.AdamWConfig` (default: cosine
    schedule over ``steps``, peak learning rate ``0.01`` x the layout
    extent, no weight decay, clip_norm 1.0); ``weights`` a
    :class:`~repro_torch.core.soft.SoftWeights`; ``temperature`` /
    ``final_temperature`` the geometric annealing endpoints (default
    ``config.temperature`` down one decade); ``jitter`` the restart
    spread as a fraction of the layout extent (restart 0 is the seed
    layout itself); ``device`` where it runs (CUDA unless the caller
    passes another, ``mesh.device`` with a mesh); ``mesh`` the
    :class:`~repro_torch.distributed.compat.Mesh` of
    ``backend="distributed"`` (default: the serving policy's).
    """

    def __init__(self, config: EvalConfig = None, *, steps: int = 100,
                 restarts: int = 8, rescore_every: int = 25,
                 opt: adamw.AdamWConfig = None,
                 weights: soft.SoftWeights = None,
                 temperature: float = None, final_temperature: float = None,
                 jitter: float = 0.05, seed: int = 0, mesh=None,
                 device=None):
        self.config = config if config is not None else EvalConfig()
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if restarts < 1:
            raise ValueError(f"restarts must be >= 1, got {restarts}")
        self.steps = int(steps)
        self.restarts = int(restarts)
        self.rescore_every = max(1, int(rescore_every))
        self.opt = opt
        self.weights = weights if weights is not None else soft.SoftWeights()
        t0 = (float(temperature) if temperature is not None
              else self.config.temperature)
        t1 = (float(final_temperature) if final_temperature is not None
              else t0 * 0.1)
        if not (t0 > 0 and t1 > 0):
            raise ValueError("temperatures must be > 0, got "
                             f"{t0!r} -> {t1!r}")
        self.temperature = t0
        self.final_temperature = t1
        self.jitter = float(jitter)
        self.seed = int(seed)
        if device is None and mesh is not None:
            device = mesh.device
        self.device = engine.resolve_device(device)
        self.mesh = mesh

    # -- pieces -------------------------------------------------------------

    def _temperature_at(self, k: int) -> float:
        """Geometric anneal: t0 at step 0, t1 at the last step."""
        frac = k / max(self.steps - 1, 1)
        return float(self.temperature
                     * (self.final_temperature / self.temperature) ** frac)

    def _mesh(self):
        if self.mesh is None:
            from repro_torch.launch.elastic import serving_mesh
            self.mesh = serving_mesh("eval", shards=self.config.shards,
                                     device=self.device)
        return self.mesh

    def _init_batch(self, pos0, edges):
        """Restart batch from a seed layout (or an explicit batch),
        validated through the taxonomy."""
        with span("search.init"):
            pos0 = np.asarray(pos0, np.float32)
            if pos0.ndim == 2:
                rng = np.random.default_rng(self.seed)
                extent = self._extent(pos0)
                batch = np.repeat(pos0[None], self.restarts, axis=0)
                if self.restarts > 1:
                    noise = rng.standard_normal(
                        (self.restarts - 1,) + pos0.shape).astype(np.float32)
                    batch[1:] += self.jitter * extent * noise
            elif pos0.ndim == 3:
                batch = pos0.copy()
                self.restarts = batch.shape[0]
            else:
                raise InvalidInputError(
                    f"search wants a (V, 2) layout or a (B, V, 2) restart "
                    f"batch; got shape {pos0.shape}")
            batch, edges, flags = validate_batch(
                batch, np.asarray(edges, np.int32),
                mode=self.config.validation)
            if batch.shape[1] == 0:
                raise InvalidInputError("cannot search over a layout with "
                                        "zero vertices")
            return batch, edges, flags

    @staticmethod
    def _extent(pos) -> float:
        flat = np.asarray(pos, np.float32).reshape(-1, 2)
        if flat.shape[0] == 0:
            return 1.0
        span = np.ptp(flat, axis=0)
        return float(max(span.max(), 1e-6))

    def _resolve_opt(self, extent: float) -> adamw.AdamWConfig:
        if self.opt is not None:
            return self.opt
        return adamw.AdamWConfig(
            peak_lr=0.01 * extent,
            warmup_steps=max(1, min(10, self.steps // 10)),
            total_steps=self.steps, min_lr_frac=0.1,
            weight_decay=0.0, clip_norm=1.0)

    def step(self, plan, opt_cfg, pos, state, edges, tau, valid=(),
             mesh=None):
        """One search step: forward and backward of the summed soft loss
        on a leaf copy of ``pos``, then one AdamW update.  ``state`` is the
        optimizer state ``{"m", "v", "step"}`` over ``{"pos": ...}``.  With
        a ``mesh`` this rank differentiates its share of the restarts
        (their losses and gradients are row-local) and the ranks gather
        the rest.  Returns ``(new_pos, new_state, (B,) losses,
        grad_norm)``."""
        with span("search.step"):
            rows = pos
            if mesh is not None:
                per = pos.shape[0] // mesh.size
                rows = pos[mesh.rank * per:(mesh.rank + 1) * per]
            leaf = rows.detach().requires_grad_(True)
            with span("search.step.forward"):
                losses = soft.soft_loss(
                    plan, leaf, edges, tau, weights=self.weights,
                    n_valid_vertices=valid[0] if valid else None,
                    n_valid_edges=valid[1] if valid else None)
            with span("search.step.backward"):
                grad, = torch.autograd.grad(losses.sum(), leaf)
                losses = losses.detach()
                if mesh is not None:
                    from repro_torch.distributed.collectives import \
                        all_gather
                    grad = all_gather(mesh, grad)
                    losses = all_gather(mesh, losses)
            with span("search.step.adamw"), torch.no_grad():
                new, state, om = adamw.apply_updates(
                    {"pos": pos.detach()}, {"pos": grad}, state, opt_cfg,
                    adamw.cosine_schedule(opt_cfg))
            return new["pos"], state, losses, om["grad_norm"]

    def _exact_rescore(self, plan, pos_dev, edges_dev, valid, n_v, n_e,
                       mesh=None):
        """Exact scores of the current restarts (the reported numbers),
        single-host or batch-axis sharded over ``mesh``."""
        if mesh is not None:
            from repro_torch.distributed.batched import \
                evaluate_layouts_sharded
            res = evaluate_layouts_sharded(
                mesh, plan, pos_dev, edges_dev,
                n_valid_vertices=valid[0] if valid else None,
                n_valid_edges=valid[1] if valid else None)
        else:
            res = engine.evaluate_layouts(plan, pos_dev, edges_dev, *valid)
        return host_batch(res, n_v, n_e)

    # -- the run ------------------------------------------------------------

    def run(self, pos0, edges) -> SearchResult:
        """Search from ``pos0`` (a ``(V, 2)`` seed layout, jittered into
        ``restarts`` parallel starts, or an explicit ``(B, V, 2)``
        restart batch).  Returns a :class:`SearchResult` of exact
        scores; ``result.best_positions`` is the winning layout."""
        with span("search"):
            batch, edges_nat, flags = self._init_batch(pos0, edges)
            n_v, n_e = batch.shape[1], edges_nat.shape[0]

            # E=0: the engine's degenerate contract -- one masked edge row
            valid = ()
            edges_eval = edges_nat
            if n_e == 0:
                edges_eval = np.zeros((1, 2), np.int32)
                valid = (n_v, 0)

            mesh = None
            if self.config.backend == "distributed":
                mesh = self._mesh()
                pad = (-batch.shape[0]) % mesh.size
                if pad:
                    # pad the restarts to the mesh size with extra jittered
                    # starts: diversity instead of dead rows
                    rng = np.random.default_rng(self.seed + 1)
                    noise = rng.standard_normal(
                        (pad,) + batch.shape[1:]).astype(np.float32)
                    batch = np.concatenate(
                        [batch, batch[:1] + self.jitter * self._extent(batch)
                         * noise])
                    self.restarts = batch.shape[0]

            with span("search.plan"):
                plan = engine.plan_readability(batch, edges_eval,
                                               **self.config.plan_kwargs())
            opt_cfg = self._resolve_opt(self._extent(batch))
            pos, edges_dev = engine.device_inputs(batch, edges_eval,
                                                  self.device)
            state = adamw.init_state({"pos": pos})
            counters = {"rescores": 0, "replans": 0}

            def rescore(pos_dev, cur_plan):
                with span("search.rescore"):
                    counters["rescores"] += 1
                    res = self._exact_rescore(cur_plan, pos_dev, edges_dev,
                                              valid, n_v, n_e, mesh)
                    if int(np.max(res.overflow)) > 0:
                        # the layouts outgrew the plan's capacities: grow
                        # the plan from the offending batch and re-score
                        # once
                        with span("search.replan"):
                            counters["replans"] += 1
                            cur_plan = engine.replan_on_overflow(
                                cur_plan, pos_dev.cpu().numpy(), edges_eval,
                                res)
                            res = self._exact_rescore(
                                cur_plan, pos_dev, edges_dev, valid, n_v,
                                n_e, mesh)
                    return res, cur_plan

            init_res, plan = rescore(pos, plan)
            with span("search.record"):
                init_obj = batch_objectives(init_res)
                init_scores = tuple(init_res.unbatch())
                best_obj = init_obj.copy()
                best_pos = np.asarray(batch, np.float32).copy()
                best_scores = list(init_scores)
                trajectory = [dict(
                    step=0, temperature=self._temperature_at(0),
                    mean_soft_loss=None,
                    mean_objective=float(init_obj.mean()),
                    best_objective=float(best_obj.max()))]

            for k in range(self.steps):
                t_k = np.float32(self._temperature_at(k))
                tau = torch.full((), t_k, dtype=torch.float32,
                                 device=self.device)
                pos, state, losses, _ = self.step(plan, opt_cfg, pos, state,
                                                  edges_dev, tau, valid, mesh)
                if k == self.steps - 1 or (k + 1) % self.rescore_every == 0:
                    res, plan = rescore(pos, plan)
                    with span("search.record"):
                        obj = batch_objectives(res)
                        scores_list = res.unbatch()
                        pos_np = pos.cpu().numpy()
                        for i in np.flatnonzero(obj > best_obj):
                            best_obj[i] = obj[i]
                            best_pos[i] = pos_np[i]
                            best_scores[i] = scores_list[i]
                        trajectory.append(dict(
                            step=k + 1, temperature=float(t_k),
                            mean_soft_loss=float(
                                np.mean(losses.cpu().numpy())),
                            mean_objective=float(obj.mean()),
                            best_objective=float(best_obj.max())))

            if flags:
                counters["validation_flags"] = flags
            return SearchResult(
                positions=best_pos, scores=tuple(best_scores),
                objectives=best_obj, init_positions=batch,
                init_scores=init_scores, init_objectives=init_obj,
                trajectory=tuple(trajectory), steps=self.steps,
                restarts=self.restarts, counters=counters)
