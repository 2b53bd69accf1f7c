"""Shared plumbing of the serving twin tests (``test_torch_faults.py``,
``test_torch_session.py``, ``test_torch_serve.py``): one namespace per
package, a helper that runs the same scenario under each package's own
``FaultPlan``, and the comparisons.

The port's sessions run on the CPU (``device="cpu"``).  Each package has
its own fault and deprecation-warning registries, so a twin arms one
plan per package and resets both warning registries.
"""

from types import SimpleNamespace

import numpy as np

import repro.api as ref_api
import repro.core.keys as ref_keys
import repro.launch.admission as ref_admission
import repro.launch.faults as ref_faults
import repro.launch.serve as ref_serve
import repro.launch.session as ref_session
import repro_torch.api as t_api
import repro_torch.core.keys as t_keys
import repro_torch.launch.admission as t_admission
import repro_torch.launch.faults as t_faults
import repro_torch.launch.serve as t_serve
import repro_torch.launch.session as t_session

RTOL = 1e-5
INT_FIELDS = ("node_occlusion", "edge_crossing", "crossing_count_for_angle",
              "overflow", "n_vertices", "n_edges")
FLOAT_FIELDS = ("minimum_angle", "edge_length_variation",
                "edge_crossing_angle")
# a jit artifact: the reference counts traces of its jitted engine, the
# port runs eagerly and keeps the key at 0
UNCOMPARED_STATS = ("traces",)

REF = SimpleNamespace(name="ref", api=ref_api, keys=ref_keys,
                      admission=ref_admission, faults=ref_faults,
                      serve=ref_serve, session=ref_session, device={})
PORT = SimpleNamespace(name="port", api=t_api, keys=t_keys,
                       admission=t_admission, faults=t_faults,
                       serve=t_serve, session=t_session,
                       device={"device": "cpu"})
PKGS = (PORT, REF)


def make_session(pkg, config_kw, **knobs):
    """An ``EvalSession`` of ``pkg`` on ``EvalConfig(**config_kw)``."""
    return pkg.session.EvalSession(pkg.keys.EvalConfig(**config_kw),
                                   **pkg.device, **knobs)


def twin(run, **plan_kw):
    """``run(pkg)`` for the port and the reference, each under its own
    ``FaultPlan(**plan_kw)`` (or no plan when ``plan_kw`` is empty).
    Returns ``(port result, reference result)`` and checks that both
    plans injected the same faults."""
    out, injected = {}, {}
    for pkg in PKGS:
        if plan_kw:
            with pkg.faults.FaultPlan(**plan_kw) as fp:
                out[pkg.name] = run(pkg)
            injected[pkg.name] = dict(fp.injected)
        else:
            out[pkg.name] = run(pkg)
    assert injected.get("port") == injected.get("ref"), injected
    return out["port"], out["ref"]


def assert_same_scores(got, ref, what=""):
    for f in INT_FIELDS + FLOAT_FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        assert (g is None) == (r is None), (what, f)
        if g is None:
            continue
        if f in INT_FIELDS:
            assert int(g) == int(r), (what, f, g, r)
        elif np.isnan(r):
            assert np.isnan(g), (what, f, g, r)
        else:
            np.testing.assert_allclose(float(g), float(r), rtol=RTOL,
                                       err_msg=f"{what}/{f}")
    assert got.flags == ref.flags, what


def assert_same_outcomes(got, ref):
    """Slot by slot: the same error type (and its located index, reason,
    bound or overflow), or the same scores."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.ok == r.ok, (i, g.error, r.error)
        if g.ok:
            assert_same_scores(g, r, f"slot {i}")
            continue
        assert type(g.error).__name__ == type(r.error).__name__, i
        for attr in ("request_index", "reason", "overflow", "queue_depth",
                     "bound"):
            assert getattr(g.error, attr, None) == \
                getattr(r.error, attr, None), (i, attr)
        assert type(g.error.__cause__).__name__ == \
            type(r.error.__cause__).__name__, i
        assert (g.n_vertices, g.n_edges) == (r.n_vertices, r.n_edges), i


def assert_same_stats(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if k not in UNCOMPARED_STATS:
            assert got[k] == ref[k], (k, got[k], ref[k])
    assert got["traces"] == 0
