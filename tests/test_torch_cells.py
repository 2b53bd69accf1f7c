"""The port's dry-run cells (:mod:`repro_torch.launch.cells`) and the
sharded sweeps' per-rank builders against the reference's
(:mod:`repro.launch.cells`, ``lower_sharded_*``).

* ``meta`` parity: for each of the 39 cells (36 architecture cells and
  the 3 readability shapes), every number of the reference's
  ``make_cell(...).meta`` on a (1, 1) mesh equals the port's
  (``model_flops`` at rtol 1e-12), and so do the global argument bytes
  (parameters, optimizer state, batch or cache).  The reference builds
  its cells once for the module (about 5 s).
* builder parity: the three builders' per-rank programs run on a
  one-rank CPU mesh on small real inputs from a numpy seed and equal the
  reference's jitted builders on a one-device mesh: integers equal, the
  deviation sum at rtol 1e-5.
* the placement helpers of :mod:`repro_torch.distributed.sharding`.
"""

import types

import jax
import numpy as np
import pytest
import torch

from repro.distributed.compat import AxisType
from repro.distributed.compat import make_mesh as ref_make_mesh
from repro.distributed.gridded import \
    lower_sharded_reversal as ref_lower_reversal
from repro.distributed.pairwise import \
    lower_sharded_crossing as ref_lower_crossing
from repro.distributed.pairwise import \
    lower_sharded_occlusion as ref_lower_occlusion
from repro.launch import cells as ref_cells
from repro_torch.configs import all_cells
from repro_torch.configs.readability import READABILITY_SHAPES
from repro_torch.distributed.compat import make_mesh
from repro_torch.distributed.gridded import lower_sharded_reversal
from repro_torch.distributed.pairwise import (lower_sharded_crossing,
                                              lower_sharded_occlusion)
from repro_torch.distributed.sharding import (P, batch_axes,
                                              data_axis_size, local_shape,
                                              model_axis_size,
                                              shard_batch_spec,
                                              tree_shardings)
from repro_torch.launch import cells
from test_torch_gnn import one_torch_thread  # noqa: F401

CELLS = [(a, s) for a, s, _ in all_cells()] + [
    ("readability", s) for s in READABILITY_SHAPES]


@pytest.fixture(scope="module")
def ref_mesh():
    return ref_make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@pytest.fixture(scope="module")
def ref_built(ref_mesh):
    """Each cell's reference meta and global argument bytes."""
    out = {}
    for arch, shape in CELLS:
        c = ref_cells.make_cell(arch, shape, ref_mesh)
        nbytes = sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                     for x in jax.tree_util.tree_leaves(c.abstract_args))
        out[(arch, shape)] = (c.meta, nbytes, c.kind)
    return out


@pytest.fixture(scope="module")
def port_mesh():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


def test_cell_list():
    assert len(CELLS) == 39
    assert len([c for c in all_cells(include_skipped=True) if c[2]]) == 4


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}:{s}" for a, s in CELLS])
def test_make_cell_meta_parity(arch, shape, ref_built, port_mesh):
    """Every number of the reference's meta, and the global bytes of the
    arguments, are the port's."""
    meta, nbytes, kind = ref_built[(arch, shape)]
    cell = cells.make_cell(arch, shape, port_mesh)
    assert cell.kind == kind
    for key, want in meta.items():
        if isinstance(want, (int, float)) and not isinstance(want, bool):
            got = cell.meta[key]
            if key == "model_flops":
                np.testing.assert_allclose(got, want, rtol=1e-12)
            else:
                assert got == want, key
        elif isinstance(want, str) or want is None:
            assert cell.meta[key] == want, key
    assert cells.argument_bytes(cell) == nbytes
    dtype = cell.meta["compute_dtype"]
    assert dtype == (torch.bfloat16 if arch in (
        "codeqwen1.5-7b", "internlm2-20b", "qwen3-4b", "qwen2-moe-a2.7b",
        "llama4-scout-17b-a16e") else torch.float32)


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------

def _occlusion_inputs(args, n, rng):
    n_pad = args[3].shape[0]
    x = np.zeros(n_pad, np.float32)
    y = np.zeros(n_pad, np.float32)
    ok = np.zeros(n_pad, bool)
    x[:n], y[:n] = rng.uniform(0, 6, (2, n)).astype(np.float32)
    ok[:n] = rng.random(n) < 0.9
    return (x[None], y[None], ok[None], x, y, ok)


def _crossing_inputs(sh, n, rng):
    e_pad = sh[0].shape[1]
    cols = [np.zeros(e_pad, np.float32) for _ in range(4)]
    for c in cols:
        c[:n] = rng.uniform(0, 10, n)
    v = np.full(e_pad, -1, np.int32)
    u = np.full(e_pad, -2, np.int32)
    v[:n] = rng.integers(0, 40, n)
    u[:n] = (v[:n] + rng.integers(1, 40, n)) % 40
    ok = np.zeros(e_pad, bool)
    ok[:n] = rng.random(n) < 0.95
    rep = (*cols, v, u, ok)
    return tuple(a[None] for a in rep), rep


def _reversal_inputs(args, rng):
    shape = args[0].shape
    return (rng.uniform(0, 5, shape).astype(np.float32),
            rng.uniform(0, 5, shape).astype(np.float32),
            rng.uniform(0, np.pi, shape).astype(np.float32),
            rng.integers(0, 30, shape).astype(np.int32),
            rng.integers(0, 30, shape).astype(np.int32),
            rng.random(shape) < 0.85)


def _t(tree):
    if isinstance(tree, tuple):
        return tuple(_t(a) for a in tree)
    return torch.from_numpy(np.ascontiguousarray(tree))


def test_occlusion_builder_parity(ref_mesh, port_mesh):
    rng = np.random.default_rng(31)
    fn, args = lower_sharded_occlusion(port_mesh, 300, 0.5, block=64)
    ref_fn, ref_args = ref_lower_occlusion(ref_mesh, 300, 0.5, block=64)
    assert [tuple(a.shape) for a in args] == [a.shape for a in ref_args]
    inputs = _occlusion_inputs(args, 300, rng)
    want = int(ref_fn(*inputs))
    assert want > 0
    assert int(fn(*_t(inputs))) == want


@pytest.mark.parametrize("predicate", ["sign", "bool"])
def test_crossing_builder_parity(predicate, ref_mesh, port_mesh):
    rng = np.random.default_rng(32)
    fn, (sh, rep) = lower_sharded_crossing(port_mesh, 200, block=32,
                                           predicate=predicate)
    ref_fn, (ref_sh, ref_rep) = ref_lower_crossing(
        ref_mesh, 200, block=32, predicate=predicate)
    assert [tuple(a.shape) for a in sh + rep] == \
        [a.shape for a in ref_sh + ref_rep]
    s, r = _crossing_inputs(sh, 200, rng)
    want = int(ref_fn(s, r))
    assert want > 0
    assert int(fn(_t(s), _t(r))) == want


@pytest.mark.parametrize("with_angle", [False, True])
def test_reversal_builder_parity(with_angle, ref_mesh, port_mesh):
    """10 strips in blocks of 4 (the reference's last block overlaps the
    one before it, and so does the port's)."""
    rng = np.random.default_rng(33)
    kw = dict(strip_block=4, with_angle=with_angle,
              ideal_angle=1.2 if with_angle else None)
    fn, args = lower_sharded_reversal(port_mesh, 10, 24, **kw)
    ref_fn, ref_args = ref_lower_reversal(ref_mesh, 10, 24, **kw)
    assert [tuple(a.shape) for a in args] == [a.shape for a in ref_args]
    inputs = _reversal_inputs(args, rng)
    want_c, want_d = ref_fn(*inputs)
    got_c, got_d = fn(*_t(inputs))
    assert int(got_c) == int(want_c) > 0
    np.testing.assert_allclose(float(got_d), float(want_d), rtol=1e-5)


# ---------------------------------------------------------------------------
# placement helpers
# ---------------------------------------------------------------------------

POD = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                            shape=(2, 16, 16))


def test_axis_helpers(port_mesh):
    assert batch_axes(port_mesh) == ("data",)
    assert batch_axes(POD) == ("pod", "data")
    assert model_axis_size(POD) == 16 and data_axis_size(POD) == 32
    assert shard_batch_spec(POD, None) == P(("pod", "data"), None)


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard
    spec_tree = {"w": P(None, "model"), "b": [P(), P(("pod", "data"))]}
    got = tree_shardings(POD, spec_tree)
    assert got == {"w": (Replicate(), Replicate(), Shard(1)),
                   "b": [(Replicate(),) * 3,
                         (Shard(0), Shard(0), Replicate())]}
    assert local_shape(POD, (64, 100), P(("pod", "data"), "model")) == (2, 7)
    with pytest.raises(ValueError, match="twice"):
        tree_shardings(POD, P("model", "model"))


@pytest.mark.parametrize("arch,shape", [("gcn-cora", "full_graph_sm"),
                                        ("readability", "exact_occlusion")])
def test_cells_run_for_real_on_one_rank(arch, shape, port_mesh):
    """What ``chip_smoke.py`` (n2) runs on the card, here on the CPU: the
    cell's step on real arguments of the cell's shapes (``real_args``,
    ``readability_args``), whose bytes are the cell's, with a finite loss
    (a count equal to a NumPy recount of the occluded pairs)."""
    cell = cells.make_cell(arch, shape, port_mesh, config_patch=(
        {"dataset": "ego-Facebook"} if arch == "readability" else None))
    gen = torch.Generator().manual_seed(5)
    if arch == "readability":
        args = cells.readability_args(cell, port_mesh, "cpu", gen)
        x, y, ok = (a.numpy() for a in args[3:])
        i, j = np.triu_indices(int(ok.sum()), 1)
        d2 = (x[i] - x[j]) ** 2 + (y[i] - y[j]) ** 2
        assert int(cell.fn(*args)) == int((d2 < 1.0).sum()) > 0
    else:
        args = cells.real_args(cell, "cpu", gen)
        assert np.isfinite(float(cell.fn(*args)[2]["loss"]))
    leaves = [t for t in cells._leaves(args)]
    assert sum(t.numel() * t.element_size() for t in leaves) \
        == cells.argument_bytes(cell)
