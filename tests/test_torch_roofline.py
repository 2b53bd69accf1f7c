"""The port's roofline terms (:mod:`repro_torch.roofline.analysis`)
against the reference's (:mod:`repro.roofline.analysis`): byte counts of
shapes and collectives, and the counting semantics of a trace over fake
ranks.

Twins: ``tests/test_roofline.py::test_shape_bytes`` (its four cases),
``test_collective_parser`` (its three collectives, given as the records
a trace makes in place of HLO text) and ``test_analyze_cell_small_mesh``.
``test_cost_analysis_loop_semantics`` has no twin: XLA counts a loop body
once, a trace counts every trip, which is the opposite and is tested
here.  The scenarios that need a fake process group run in a child
process each (``tests/_torch_fake_ranks.py``).
"""

import pytest
import torch

import _torch_fake_ranks as fake
from repro.roofline.analysis import _shape_bytes
from repro.roofline.analysis import collective_bytes as ref_collective_bytes
from repro_torch.roofline.analysis import (CARDS_PER_NODE, NODE_LINK_BW,
                                           NVLINK_BW, CostRecorder,
                                           collective_bytes,
                                           collective_seconds, link_bw,
                                           shape_bytes, terms_of)
from test_torch_gnn import one_torch_thread  # noqa: F401

# test_roofline.py::test_shape_bytes's HLO shapes and the same buffers
SHAPES = [("f32[128,256]", [(torch.float32, (128, 256))]),
          ("bf16[8]", [(torch.bfloat16, (8,))]),
          ("(f32[4,4], s32[2])", [(torch.float32, (4, 4)),
                                  (torch.int32, (2,))]),
          ("pred[16]", [(torch.bool, (16,))])]


@pytest.mark.parametrize("hlo,parts", SHAPES, ids=[s for s, _ in SHAPES])
def test_shape_bytes(hlo, parts):
    assert sum(shape_bytes(d, s) for d, s in parts) == _shape_bytes(hlo)


def test_collective_bytes():
    """test_collective_parser's three collectives give the reference's
    numbers: an all-gather of f32[64,128] over 4, an all-reduce of
    bf16[1024] over 32, a collective-permute of f32[256]."""
    hlo = """
  %ag = f32[64,128]{1,0} all-gather(f32[4,128] %x), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = bf16[1024]{0} all-reduce(bf16[1024] %y), replica_groups=[16,32]<=[512], to_apply=%add
  %cp = f32[256]{0} collective-permute(f32[256] %z), source_target_pairs={{0,1}}
  %other = f32[8] add(f32[8] %a, f32[8] %b)
"""
    records = [
        {"kind": "all-gather", "bytes": shape_bytes(torch.float32, (64, 128)),
         "group_size": 4},
        {"kind": "all-reduce", "bytes": shape_bytes(torch.bfloat16, (1024,)),
         "group_size": 32},
        {"kind": "collective-permute",
         "bytes": shape_bytes(torch.float32, (256,)), "group_size": 2}]
    assert collective_bytes(records) == ref_collective_bytes(hlo)


def test_collectives_recorded_on_a_fake_group():
    """On a fake group of 4, an all-gather of a (16, 128) float32 shard
    and an all-reduce of bf16[1024] are recorded with their full buffers
    and group size, at NVLink's rate (4 ranks of one node)."""
    recs = fake.run("collectives")
    assert recs == [
        {"kind": "all-gather", "bytes": 64 * 128 * 4, "group_size": 4,
         "bw": NVLINK_BW},
        {"kind": "all-reduce", "bytes": 1024 * 2, "group_size": 4,
         "bw": NVLINK_BW}]


def test_link_rates():
    """A group inside one node of 8 consecutive ranks runs on NVLink; one
    that spans nodes on the inter-node port."""
    assert link_bw(range(CARDS_PER_NODE)) == NVLINK_BW
    assert link_bw([8, 15]) == NVLINK_BW
    assert link_bw([7, 8]) == NODE_LINK_BW
    assert link_bw(range(0, 256, 16)) == NODE_LINK_BW
    rec = {"kind": "all-reduce", "bytes": 1000, "group_size": 4,
           "bw": NODE_LINK_BW}
    assert collective_seconds([rec]) == 2 * 0.75 * 1000 / NODE_LINK_BW


def test_three_products_count_three_times_2mnk():
    """Straight-line products count 2mnk each (a transpose is a view and
    counts nothing)."""
    m = k = n = 64
    rec = CostRecorder()
    with rec:
        a = torch.empty(m, k)
        b = torch.empty(k, n)
        ((a @ b) @ b.T) @ b
    assert rec.flops == 3 * 2 * m * k * n


def test_a_python_loop_counts_every_trip():
    """A loop of 8 steps counts 8 times one step: the opposite of
    ``test_cost_analysis_loop_semantics``, where XLA counts a ``while``
    body once whatever its trip count."""
    def count(steps):
        rec = CostRecorder()
        with rec:
            c = torch.empty(32, 32)
            y = torch.empty(32, 32)
            for _ in range(steps):
                c = torch.tanh(c @ y)
        return rec.flops, rec.bytes

    f1, b1 = count(1)
    f8, b8 = count(8)
    assert f1 == 2 * 32 ** 3 + 32 * 32
    assert (f8, b8) == (8 * f1, 8 * b1)


def test_elementwise_and_reduction_counts():
    """An elementwise op counts one flop per output element (its inputs
    and output in bytes); a reduction one per input element."""
    rec = CostRecorder()
    with rec:
        x = torch.empty(64, 32)
        y = torch.empty(64, 32)
        z = x + y
    assert (rec.flops, rec.bytes) == (64 * 32, 3 * 64 * 32 * 4)
    with rec:
        z.sum()
    assert rec.flops == 2 * 64 * 32


def test_peak_counts_local_shards():
    """``x`` (8, 16) float32 split on dim 0 over the 2 ``data`` ranks of a
    (2, 2) fake mesh and ``y = x * 2``: rank 0 holds 4 x 16 x 4 = 256
    bytes of each, so the arguments are 256 bytes and the peak 512."""
    out = fake.run("memory")
    assert out == {"argument": 256, "peak": 512, "flops": 64.0,
                   "bytes": 512.0, "local": [4, 16]}


def test_compute_s_divides_by_the_cells_dtype_peak():
    cost = {"flops": 1e12, "bytes accessed": 3.35e12,
            "collectives": {"total": 0.0, "seconds": 0.0}}
    bf16 = terms_of(cost, {"compute_dtype": torch.bfloat16}, arch="a",
                    shape="s", mesh_name="m", chips=2)
    f32 = terms_of(cost, {"compute_dtype": torch.float32}, arch="a",
                   shape="s", mesh_name="m", chips=2)
    assert bf16.compute_s == 1e12 / 989.4e12
    assert f32.compute_s == 1e12 / 66.9e12
    assert f32.memory_s == 1.0 and f32.dominant == "memory"
    assert f32.flops_global == 2e12


def test_analyze_cell_small_mesh():
    """Twin of ``test_analyze_cell_small_mesh``: ``xdeepfm`` x
    ``serve_p99`` on a (1, 2) fake mesh."""
    terms = fake.run("analyze")
    assert terms["compute_s"] > 0
    assert terms["memory_s"] > 0
    assert terms["dominant"] in ("compute", "memory", "collective")
    assert terms["flops_global"] > terms["model_flops"] * 0.2
    assert terms["chips"] == 2


def _trip(f, s, w, u):
    return torch.tanh(f.index_select(0, s) @ w)


def _trips(replay):
    """Eight remat trips of ``_trip`` (``u`` unused) and the gradients of
    ``f`` and ``w``, traced with or without the trip cache."""
    from repro_torch.models import common

    rec = CostRecorder()
    if not replay:
        rec.trip_cache = None
    with rec:
        f = torch.empty(64, 32, requires_grad=True)
        w = torch.empty(32, 32, requires_grad=True)
        u = torch.empty(32, 32, requires_grad=True)
        s = torch.zeros(256, dtype=torch.long)
        outs = [common._recorded(_trip, f, s[i:i + 32], w, u)
                for i in range(0, 256, 32)]
        grads = torch.autograd.grad(torch.cat(outs).sum(), [f, w])
    if replay:
        rec.trip_cache.check()
        assert (rec.trip_cache.ran, rec.trip_cache.replayed) == (1, 7)
    assert [tuple(g.shape) for g in grads] == [(64, 32), (32, 32)]
    return rec.flops, rec.bytes, rec.peak


def test_repeated_trips_replay_the_same_counts():
    """A remat trip that repeats an earlier one's shapes replays its
    recorded costs: the flops and bytes of eight trips, forward and
    backward, equal a trace that runs all eight; the peak is within a
    few percent (the replay's live bytes are the first trip's)."""
    f1, b1, p1 = _trips(True)
    f0, b0, p0 = _trips(False)
    assert (f1, b1) == (f0, b0)
    assert abs(p1 - p0) <= 0.1 * p0


def test_a_gather_reads_its_rows_not_the_table():
    """An embedding lookup of 8 rows from a (1000, 16) float32 table
    moves the rows twice (read, write) and the int64 index, not the
    table; an elementwise op over the table moves the table."""
    rec = CostRecorder()
    with rec:
        table = torch.empty(1000, 16)
        ids = torch.empty(8, dtype=torch.long)
        torch.nn.functional.embedding(ids, table)
    assert rec.bytes == 2 * 8 * 16 * 4 + 8 * 8
    with rec:
        table * 2.0
    assert rec.bytes == 2 * 8 * 16 * 4 + 8 * 8 + 2 * 1000 * 16 * 4
