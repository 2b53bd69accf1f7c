"""The plain reference and the roofline's pair counts against brute-force
enumerations at small sizes, and against the program on the CPU."""

import itertools
import math

import numpy as np
import pytest
import torch

from bench import find
from bench.metrics import _work
from bench.reference import pairs, scores, strips

F = np.float32
random_edges = find.module("generators", "random_edges").random_edges
layout_local_graph = find.module("generators",
                                 "layout_local_graph").layout_local_graph


def _layout(n, seed, scale=10.0, grid=None):
    rng = np.random.default_rng(seed)
    if grid:   # integer coordinates: collinear pairs and T-junctions
        return rng.integers(0, grid, size=(n, 2)).astype(F)
    return rng.uniform(0, scale, size=(n, 2)).astype(F)


def _brute_occlusion(pos, radius):
    t = F((2.0 * radius) ** 2)
    n = 0
    for i, j in itertools.combinations(range(len(pos)), 2):
        dx, dy = F(pos[i, 0] - pos[j, 0]), F(pos[i, 1] - pos[j, 1])
        n += F(F(dx * dx) + F(dy * dy)) < t
    return n


def _cross(p, q, r):
    return F(F(F(q[0] - p[0]) * F(r[1] - p[1]))
             - F(F(q[1] - p[1]) * F(r[0] - p[0])))


def _straddle(a, b):
    return np.sign(a) * np.sign(b) <= 0


def _brute_crossings(pos, edges, ideal):
    straddles = crossings = 0
    dev = 0.0
    th = [math.atan2(float(F(pos[v, 1] - pos[u, 1])),
                     float(F(pos[v, 0] - pos[u, 0]))) % math.pi
          for u, v in edges]
    for i, j in itertools.combinations(range(len(edges)), 2):
        (a, b), (c, d) = edges[i], edges[j]
        p1, q1, p2, q2 = pos[a], pos[b], pos[c], pos[d]
        if not (_straddle(_cross(p1, q1, p2), _cross(p1, q1, q2))
                and _straddle(_cross(p2, q2, p1), _cross(p2, q2, q1))):
            continue
        straddles += 1
        if {a, b} & {c, d}:
            continue
        crossings += 1
        dd = abs(th[i] - th[j])
        dev += abs(ideal - min(dd, math.pi - dd)) / ideal
    return straddles, crossings, dev


@pytest.mark.parametrize("seed,radius", [(0, 0.5), (1, 1.0), (2, 2.5)])
def test_occlusion_count_matches_enumeration(seed, radius):
    pos = _layout(150, seed)
    got = pairs.occlusion_count(torch.from_numpy(pos[:, 0]),
                                torch.from_numpy(pos[:, 1]), radius,
                                block=16)
    assert got == _brute_occlusion(pos, radius)


@pytest.mark.parametrize("grid", [None, 6])
def test_crossing_stats_match_enumeration(grid):
    pos = _layout(40, 5, grid=grid)
    edges = random_edges(40, 90, seed=6)
    got = pairs.crossing_stats(torch.from_numpy(pos),
                               torch.from_numpy(edges), scores.IDEAL_70,
                               block=7)
    s, c, dev = _brute_crossings(pos, edges, scores.IDEAL_70)
    assert (got["straddles"], got["crossings"]) == (s, c)
    assert got["dev_sum"] == pytest.approx(dev, rel=1e-5)


def test_strip_stats_match_enumeration():
    pos = _layout(60, 7)
    edges = random_edges(60, 150, seed=8)
    n_strips = 9
    strip, yl, yr, th, v, u = (t.numpy() for t in strips.strip_segments(
        torch.from_numpy(pos), torch.from_numpy(edges), n_strips, 0))
    # every segment lies in a strip that its edge spans
    lo = min(pos[edges].reshape(-1, 2)[:, 0])
    hi = max(pos[edges].reshape(-1, 2)[:, 0])
    w = (hi - lo) / n_strips
    x = pos[edges][:, :, 0]
    e_of = [np.flatnonzero((edges[:, 0] == a) & (edges[:, 1] == b))[0]
            for a, b in zip(v, u)]
    for s, e in zip(strip, e_of):
        assert x[e].min() <= lo + s * w + 1e-4
        assert x[e].max() >= lo + (s + 1) * w - 1e-4
    n_pairs = rev = cross = 0
    for i, j in itertools.permutations(range(len(strip)), 2):
        if strip[i] != strip[j]:
            continue
        n_pairs += i < j
        if yl[i] < yl[j] and yr[i] > yr[j]:
            rev += 1
            cross += not ({v[i], u[i]} & {v[j], u[j]})
    got = strips.strip_stats(torch.from_numpy(pos), torch.from_numpy(edges),
                             n_strips, 0, scores.IDEAL_70, pair_budget=50)
    assert (got["pairs"], got["reversals"], got["crossings"]) == (
        n_pairs, rev, cross)


def test_cell_pairs_match_enumeration():
    pos = _layout(300, 9, scale=8.0)
    radius = 0.5
    cell = np.floor((pos - pos.min(axis=0)) / (2 * radius)).astype(int)
    n = 0
    for i, j in itertools.combinations(range(len(pos)), 2):
        d = cell[j] - cell[i]
        n += abs(d[0]) <= 1 and abs(d[1]) <= 1
    assert _work.cell_pairs(torch.from_numpy(pos), radius) == n


def test_exact_work_counts_every_pair_once():
    ops, nbytes = _work.exact_work(
        5, 4, dict(straddles=2, crossings=1, occlusions=3))
    assert ops == 25 * 6 + 4 * 2 + 7 * 1 + 6 * 10 + 3
    assert nbytes == 8 * 5 + 8 * 4


def test_minimum_angle_and_edge_length_by_loops():
    pos = _layout(30, 10)
    edges = random_edges(30, 60, seed=11)
    d_sum, counted = 0.0, 0
    for v in range(30):
        ang = sorted(math.atan2(float(pos[b, 1]) - float(pos[v, 1]),
                                float(pos[b, 0]) - float(pos[v, 0]))
                     % (2 * math.pi)
                     for a, b in np.concatenate([edges, edges[:, ::-1]])
                     if a == v)
        if not ang:
            continue
        gaps = [b - a for a, b in zip(ang, ang[1:])]
        gaps.append(2 * math.pi - (ang[-1] - ang[0]))
        ideal = 2 * math.pi / len(ang)
        d_sum += (ideal - min(gaps)) / ideal
        counted += 1
    t_pos, t_e = torch.from_numpy(pos), torch.from_numpy(edges)
    assert scores.minimum_angle(t_pos, t_e) == pytest.approx(
        1 - d_sum / counted, rel=1e-9)
    p64 = pos.astype(float)
    ln = np.hypot(*(p64[edges[:, 0]] - p64[edges[:, 1]]).T)
    m_l = math.sqrt(((ln - ln.mean()) ** 2).sum()
                    / (len(ln) * ln.mean() ** 2)) / math.sqrt(len(ln) - 1)
    assert scores.edge_length_variation(t_pos, t_e) == pytest.approx(
        m_l, rel=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_agrees_with_the_program_on_the_cpu(seed):
    from repro_torch.api import EvalConfig, Evaluator, evaluate_exact
    edges = random_edges(200, 900, seed=seed, skew=0.6)
    pos = np.random.default_rng(seed).uniform(0, 100, (200, 2)).astype(F)
    got = evaluate_exact(pos, edges, config=EvalConfig(radius=0.5),
                         device="cpu")
    want = scores.exact_scores(torch.from_numpy(pos),
                               torch.from_numpy(edges), radius=0.5)
    for f in ("node_occlusion", "edge_crossing", "crossing_count_for_angle"):
        assert getattr(got, f) == want[f]
    for f in ("minimum_angle", "edge_length_variation",
              "edge_crossing_angle"):
        assert getattr(got, f) == pytest.approx(want[f], rel=1e-5)
    base, edges = layout_local_graph(900, seed=seed, frac_long=0.01)
    batch = base + np.random.default_rng(seed).normal(
        0, 0.05, (2,) + base.shape).astype(F)
    ev = Evaluator(EvalConfig(radius=0.5, n_strips=32), device="cpu")
    got = ev.evaluate_batch(batch, edges, plan=ev.plan(batch, edges))
    for m in range(2):
        want = scores.enhanced_scores(torch.from_numpy(batch[m]),
                                      torch.from_numpy(edges), radius=0.5,
                                      n_strips=32)
        for f in ("node_occlusion", "edge_crossing",
                  "crossing_count_for_angle"):
            assert getattr(got, f)[m] == want[f]
        for f in ("minimum_angle", "edge_length_variation",
                  "edge_crossing_angle"):
            assert getattr(got, f)[m] == pytest.approx(want[f], rel=1e-5)
