"""Roofline terms of a dry-run cell, from a trace over fake ranks
(counterpart of :mod:`repro.roofline.analysis`).

Per (arch x shape x mesh), for the program of one rank:

    compute_s    = flops_per_dev        / PEAK_FLOPS[compute dtype]
    memory_s     = bytes_per_dev        / HBM_BW
    collective_s = sum over collectives of ring bytes / link rate

Where the numbers come from.  The reference reads XLA's
``cost_analysis()`` and ``memory_analysis()`` and parses the collectives
out of the partitioned HLO.  The port runs the cell's step once on fake
``DTensor`` shards (:func:`repro_torch.launch.cells.trace_cell`) under
:class:`CostRecorder`, the ``FakeTensorMode`` of the trace, which sees
every op rank 0 would run, on its local shards:

* flops: ``torch.utils.flop_counter``'s formulas for the matrix products
  and attention; one flop per output element of a pointwise op and per
  input element of a reduction (and of a scatter-add); none for data
  movement;
* bytes: each op's tensor inputs plus its outputs (views move none), what
  eager PyTorch moves, since nothing fuses; a gather (``embedding``,
  ``index_select``, indexing) reads the rows it returns and its index,
  not the whole table;
* collectives: every ``_c10d_functional`` collective with its kind, its
  buffer's bytes and its group;
* peak bytes: the live local storages while the step runs.

Unlike XLA's count, which takes a ``while`` body once whatever its trip
count, a Python loop is traced trip by trip: the count of a loop of 8
steps is 8 times one step's.  So the reference's two extrapolations go
away (the L=1 / L=2 layer twins of the scanned LMs and the two reduced
edge counts of the big equivariant cells) and every cell is counted at
its full size.  A remat trip that repeats an earlier trip's shapes (an
edge chunk, a row chunk) replays that trip's recorded costs instead of
running again (:class:`TripCache`): the same count, in the time of one
trip, which is what equiformer-v2's 11,000 edge chunks per step need.

Where DTensor has no sharding rule for an op, or refuses one (a view
that would split a shard, a rule that reads values), the op runs on
replicated inputs (:func:`_replicate_fallback`, :class:`ReplicatingCalls`,
:class:`ReplicatingOps`): the all-gathers that costs are recorded and
charged, and the ops are listed in the trace's ``replicated``.

Hardware model: one NVIDIA H100 SXM (data sheet): 989.4e12 FLOP/s dense
bfloat16, 66.9e12 FLOP/s float32 (TF32 off, an FMA counted as two),
3.35e12 B/s HBM3, 450e9 B/s per NVLink direction within a node of 8
cards, 50e9 B/s per card between nodes (one 400 Gb/s NDR port each).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map_only

PEAK_FLOPS = {torch.bfloat16: 989.4e12, torch.float16: 989.4e12,
              torch.float32: 66.9e12}
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per direction, within a node
NODE_LINK_BW = 50e9          # bytes/s per card, between nodes
CARDS_PER_NODE = 8
HBM_BYTES = 80 * 10 ** 9     # one H100's memory

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")


def shape_bytes(dtype, shape) -> int:
    """Bytes of a dense ``shape`` tensor of ``dtype`` (the twin of the
    reference's ``_shape_bytes`` of an HLO shape string)."""
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def collective_bytes(records) -> dict:
    """Per-device link traffic by collective kind (ring-algorithm model):
    all-gather, reduce-scatter and all-to-all move ``(g-1)/g`` of the full
    buffer, all-reduce twice that, collective-permute the full buffer.
    ``records``: dicts ``{"kind", "bytes", "group_size"}`` (``bytes`` the
    full buffer: the gathered output, the scattered input)."""
    out = dict.fromkeys(_KINDS, 0.0)
    for r in records:
        kind, nbytes, g = r["kind"], r["bytes"], r["group_size"]
        ring = (g - 1) / max(g, 1)
        if kind == "all-reduce":
            out[kind] += 2.0 * ring * nbytes
        elif kind == "collective-permute":
            out[kind] += float(nbytes)
        else:
            out[kind] += ring * nbytes
    out["total"] = sum(out.values())
    return out


def collective_seconds(records) -> float:
    """Seconds of link time of ``records`` (each with its ``bw``): ring
    bytes over the rate of the link its group crosses."""
    return sum(collective_bytes([r])["total"] / r["bw"] for r in records)


def link_bw(ranks) -> float:
    """The link rate of a collective over ``ranks``: NVLink when they all
    sit in one node of 8 consecutive ranks, else the inter-node port."""
    nodes = {r // CARDS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NODE_LINK_BW


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}
# ops that return a tensor without moving its bytes
_FREE = {"_unsafe_view", "lift_fresh", "empty", "empty_strided",
         "empty_like", "new_empty", "new_empty_strided", "wait_tensor"}
# gathers: they read the rows they return (and the index), not the table
_GATHERS = {"embedding", "index_select", "index", "gather"}
# reductions without the reduction tag, counted per input element
_REDUCING = {"index_add", "index_add_", "scatter_add", "scatter_add_",
             "scatter_reduce", "scatter_reduce_", "index_reduce",
             "index_reduce_", "embedding_dense_backward",
             "_softmax", "_log_softmax", "_softmax_backward_data",
             "_log_softmax_backward_data", "cumsum", "cumsum_",
             "index_put", "index_put_", "_index_put_impl_",
             "nll_loss_forward", "nll_loss_backward", "topk", "sort"}

_STATE = threading.local()


def _in_propagation() -> bool:
    return getattr(_STATE, "propagating", 0) > 0


def _guard_propagation():
    """DTensor finds each op's output shape by running it once on fake
    tensors of the *global* shapes; those runs are not rank 0's work.
    Mark them so the recorder skips them (idempotent)."""
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        if getattr(prop, f"_repro_{name}", False):
            return
        orig = getattr(type(prop), name, None)
        if orig is None:
            continue

        def wrapped(op_schema, _orig=orig):
            _STATE.propagating = getattr(_STATE, "propagating", 0) + 1
            try:
                return _orig(prop, op_schema)
            finally:
                _STATE.propagating -= 1

        setattr(prop, name, wrapped)
        setattr(prop, f"_repro_{name}", True)
        return
    raise RuntimeError("this torch's DTensor has no tensor-meta "
                       "propagation hook to guard")


def _has_strategy(func) -> bool:
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prop = disp.sharding_propagator
    return (func in prop.op_strategy_funcs
            or func in getattr(prop, "op_to_rules", {})
            or func in getattr(disp, "_custom_op_handlers", {})
            or func in getattr(prop, "op_single_dim_strategy_funcs", {}))


def replicate_fallbacks(ops):
    """:func:`_replicate_fallback` for each of ``ops`` that has no DTensor
    rule (a run on real ``DTensor`` s, where no recorder finds them)."""
    for func in ops:
        if not _has_strategy(func):
            _replicate_fallback(func)


def _replicate_fallback(func):
    """Register for ``func`` a sharding strategy that takes every tensor
    input ``Replicate()`` and gives replicated outputs: DTensor then
    all-gathers the inputs before the op (recorded and charged) and runs
    it on the whole tensors."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding

    n_out = len(func._schema.returns)

    def strategy(*args, **kwargs):
        ins = []
        for a in args:
            if isinstance(a, (list, tuple)) and a and all(
                    hasattr(x, "placements") for x in a):
                ins.append([Replicate()] * len(a))
            else:
                ins.append(Replicate() if hasattr(a, "placements")
                           else None)
        return [([Replicate()] * n_out, ins)]

    register_sharding(func)(strategy)


def _nbytes(t) -> int:
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


# calls that run a graph: a failure inside is not theirs to retry
_NO_RETRY = {torch.Tensor.backward, torch.autograd.backward,
             torch.autograd.grad}


def _sharding_failed(err) -> bool:
    from torch._subclasses.fake_tensor import DataDependentOutputException

    if isinstance(err, DataDependentOutputException):
        # a DTensor rule that reads values (argmax's global index)
        return True
    text = str(err)
    return ("Sharding propagation failed" in text
            or "without redistribution" in text
            or "must be normalized" in text
            or "does not have a sharding strategy" in text
            or "unevenly sharded" in text)


def _whole(t):
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


class ReplicatingCalls(TorchFunctionMode):
    """Where DTensor's sharding propagation refuses a call on sharded
    inputs (a view that would split a shard, a rule that reads values),
    redistribute the call's ``DTensor`` inputs to ``Replicate()`` and
    call again: the all-gathers are recorded and charged like any other.
    The calls it replicated are kept in ``replicated`` (the recorder's,
    when given).  It also serves a run on real ``DTensor`` s.  A call
    that runs a graph (``backward``) is not retried; the ops inside it
    are :class:`ReplicatingOps`' to retry, and a remat block recomputed
    there runs under this mode again (:meth:`CostRecorder.
    recompute_context`)."""

    def __init__(self, recorder=None):
        super().__init__()
        self.replicated = set() if recorder is None else recorder.replicated

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        try:
            return func(*args, **kwargs)
        except Exception as err:  # noqa: BLE001 - only sharding refusals
            if not _sharding_failed(err) or func in _NO_RETRY:
                raise
        args, kwargs = tree_map_only(DTensor, _whole, (args, kwargs))
        self.replicated.add(getattr(func, "__name__", str(func)))
        return func(*args, **kwargs)


class ReplicatingOps(TorchDispatchMode):
    """:class:`ReplicatingCalls` at the dispatch level, for the ops no
    Python call reaches: the backward's.  An in-place op is never
    retried, and when the retry fails too the first error stands (for a
    call around the op to retry)."""

    def __init__(self, recorder=None):
        super().__init__()
        self.replicated = set() if recorder is None else recorder.replicated

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except Exception as err:  # noqa: BLE001 - only sharding refusals
            if not _sharding_failed(err) or func._schema.is_mutable:
                raise
            first = err
        try:
            args, kwargs = tree_map_only(DTensor, _whole, (args, kwargs))
            out = func(*args, **kwargs)
        except Exception:  # noqa: BLE001 - the first refusal stands
            raise first from None
        self.replicated.add(str(func.overloadpacket))
        return out


class CostRecorder(FakeTensorMode):
    """A ``FakeTensorMode`` that counts flops, bytes, collectives and live
    bytes of the ops it runs on its fake tensors (see the module
    docstring): a ``DTensor`` op reaches it as the local ops on rank 0's
    shards that DTensor makes of it.  ``replicated`` collects the ops run
    on replicated inputs for want of a DTensor rule."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = []
        self.replicated = set()
        self.live = 0
        self.peak = 0
        self._storages = set()
        self._depth = 0
        # the remat trips of the traced step (``models.common._recorded``)
        self.trip_cache = TripCache(self)
        _guard_propagation()

    def recompute_context(self):
        """The mode a remat block's recompute in the backward runs under:
        the function-level fallback, which is off inside ``backward``."""
        return ReplicatingCalls(self)

    # -- memory ------------------------------------------------------------

    def track(self, t) -> int:
        """Count ``t``'s storage as live until it is freed; returns its
        bytes when it is new, else 0."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)
        return n

    def _free(self, key, n):
        self._storages.discard(key)
        self.live -= n

    @staticmethod
    def storage_bytes(tensors) -> int:
        """Bytes of the distinct storages under ``tensors``."""
        seen, total = set(), 0
        for t in tensors:
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
        return total

    @contextlib.contextmanager
    def paused(self):
        """Ops run meanwhile are neither counted nor tracked."""
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    def snapshot(self):
        return self.flops, self.bytes, len(self.collectives)

    def delta(self, snap):
        flops, nbytes, n = snap
        return (self.flops - flops, self.bytes - nbytes,
                list(self.collectives[n:]))

    def add(self, delta):
        flops, nbytes, colls = delta
        self.flops += flops
        self.bytes += nbytes
        self.collectives.extend(colls)

    # -- the ops -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor redistributes and runs the local ops, which come
            # back here on the local shards
            if not _has_strategy(func):
                _replicate_fallback(func)
                self.replicated.add(str(func.overloadpacket))
            return NotImplemented
        outer = self._depth == 0
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if outer and not _in_propagation():
            ins = [a for a in tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
            outs = [o for o in tree_leaves(out)
                    if isinstance(o, torch.Tensor)]
            self._count(func, args, kwargs, out, ins, outs)
            for o in outs:
                self.track(o)
        return out

    def _count(self, func, args, kwargs, out, ins, outs):
        name = func.__name__.split(".")[0]
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            self._collective(name, args, kwargs, ins, outs)
            return
        if not outs or name in _FREE or func.is_view:
            return
        if name in _GATHERS:
            rows = sum(_nbytes(t) for t in outs)
            index = sum(_nbytes(t) for t in ins if not t.is_floating_point())
            self.bytes += 2 * rows + index
        else:
            self.bytes += sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        elif torch.Tag.pointwise in func.tags:
            self.flops += max(o.numel() for o in outs)
        elif torch.Tag.reduction in func.tags or name in _REDUCING:
            self.flops += max(t.numel() for t in ins) if ins else 0

    def _collective(self, name, args, kwargs, ins, outs):
        import torch.distributed as dist
        from torch._C._distributed_c10d import _resolve_process_group

        kind = _COLLECTIVES[name]
        group = _resolve_process_group(kwargs.get("group_name", args[-1]))
        ranks = dist.get_process_group_ranks(group)
        # the full buffer: the gathered output, the scattered input
        buf = outs if kind == "all-gather" else ins
        self.collectives.append({
            "kind": kind, "bytes": sum(_nbytes(t) for t in buf),
            "group_size": len(ranks), "bw": link_bw(ranks)})


# ---------------------------------------------------------------------------
# repeated remat trips
# ---------------------------------------------------------------------------

class _StartMark(torch.autograd.Function):
    """On the first trip's outputs: its backward runs when their
    gradients arrive, just before the trip's own backward."""

    @staticmethod
    def forward(ctx, entry, rec, *outs):
        ctx.set_materialize_grads(False)
        ctx.entry, ctx.rec = entry, rec
        return tuple(o.view_as(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        e, rec = ctx.entry, ctx.rec
        e["bwd_snap"] = rec.snapshot()
        e["bwd_live"], e["bwd_peak"] = rec.live, rec.peak
        rec.peak = rec.live
        return (None, None, *grads)


class _EndMark(torch.autograd.Function):
    """On the first trip's inputs: its backward runs when the trip's
    backward has made their gradients."""

    @staticmethod
    def forward(ctx, entry, rec, *ins):
        ctx.set_materialize_grads(False)
        ctx.entry, ctx.rec = entry, rec
        return tuple(x.view_as(x) for x in ins)

    @staticmethod
    def backward(ctx, *grads):
        e, rec = ctx.entry, ctx.rec
        if "bwd_snap" in e:
            e["bwd"] = rec.delta(e.pop("bwd_snap"))
            e["bwd_excess"] = rec.peak - e["bwd_live"]
            rec.peak = max(e["bwd_peak"], rec.peak)
            for live in e["pending"]:
                rec.add(e["bwd"])
                rec.peak = max(rec.peak, live + e["bwd_excess"])
            e["pending"] = []
        return (None, None, *grads)


class _Replay(torch.autograd.Function):
    """A repeated trip: fresh outputs of the recorded shapes, the
    recorded costs added (the backward's once measured)."""

    @staticmethod
    def forward(ctx, entry, rec, *ins):
        ctx.set_materialize_grads(False)
        ctx.entry, ctx.rec = entry, rec
        ctx.ins = [(x.shape, x.dtype, x.device) for x in ins]
        rec.peak = max(rec.peak, rec.live + entry["fwd_excess"])
        rec.add(entry["fwd"])
        return tuple(torch.empty(shape, dtype=dtype, device=dev)
                     for shape, dtype, dev in entry["outs"])

    @staticmethod
    def backward(ctx, *grads):
        e, rec = ctx.entry, ctx.rec
        if "bwd" in e:
            rec.peak = max(rec.peak, rec.live + e["bwd_excess"])
            rec.add(e["bwd"])
        else:
            e["pending"].append(rec.live)
        return (None, None, *(torch.empty(shape, dtype=dtype, device=dev)
                              for shape, dtype, dev in ctx.ins))


def _used_inputs(fn, leaves, spec, grad_in, rec):
    """Which of the inputs ``grad_in`` (indices into ``leaves``) ``fn``'s
    outputs depend on: ``fn`` run on detached copies and differentiated,
    neither counted.  Only those get a gradient edge."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves = list(leaves)
    with rec.paused(), torch.enable_grad():
        for i in grad_in:
            leaves[i] = leaves[i].detach().requires_grad_()
        outs = [o for o in tree_flatten(fn(*tree_unflatten(leaves, spec)))[0]
                if isinstance(o, torch.Tensor) and o.requires_grad]
        if not outs or not grad_in:
            return []
        grads = torch.autograd.grad(
            outs, [leaves[i] for i in grad_in],
            grad_outputs=[torch.ones_like(o) for o in outs],
            allow_unused=True)
    return [i for i, g in zip(grad_in, grads) if g is not None]


class TripCache:
    """Replays repeated remat trips (``models.common._recorded``: an edge
    chunk, a row chunk) in a trace.

    The first trip of a signature (the function, the shapes, dtypes and
    gradient flags of its tensor arguments, which must be plain local
    tensors, and its other arguments) runs under the recorder, its
    forward's costs measured, and, between two marks around it, its
    backward's (the remat recompute and the gradients).  A later trip of
    that signature does not run: its outputs are fresh tensors of the
    recorded shapes, its forward's costs are added at once and its
    backward's when its gradients arrive, or, since the engine runs the
    later trips' backward first, once the first trip's has been measured.
    Each trip counts what running it would; the trace of n equal trips
    takes about one trip's time."""

    def __init__(self, rec):
        self.rec = rec
        self.entries = {}
        self.ran = self.replayed = 0

    @staticmethod
    def _key(fn, leaves, spec):
        sig = []
        for x in leaves:
            if isinstance(x, torch.Tensor):
                if hasattr(x, "placements"):
                    return None
                sig.append((tuple(x.shape), x.dtype, x.requires_grad,
                            x.device))
            else:
                try:
                    hash(x)
                    sig.append(x)
                except TypeError:
                    sig.append(id(x))
        return fn, str(spec), tuple(sig)

    def call(self, fn, args, run):
        from torch.utils._pytree import tree_flatten, tree_unflatten

        leaves, spec = tree_flatten(args)
        key = self._key(fn, leaves, spec)
        if key is None:
            return run(fn, *args)
        entry = self.entries.get(key)
        if entry is not None and not entry["replay"]:
            self.ran += 1
            return run(fn, *args)
        if entry is not None:
            self.replayed += 1
            outs = _Replay.apply(entry, self.rec,
                                 *(leaves[i] for i in entry["grad_in"]))
            it = iter(outs)
            return tree_unflatten([next(it) if o is None else o
                                   for o in entry["consts"]],
                                  entry["spec"])
        rec = self.rec
        # the inputs the trip reaches: an input it does not use gets no
        # gradient edge, here as in a trip run without the cache
        grad_in = _used_inputs(
            fn, leaves, spec, [i for i, x in enumerate(leaves) if isinstance(
                x, torch.Tensor) and x.requires_grad], rec)
        entry = {"pending": [], "grad_in": grad_in}
        leaves = list(leaves)
        if grad_in:
            marked = _EndMark.apply(entry, rec,
                                    *(leaves[i] for i in grad_in))
            for i, m in zip(grad_in, marked):
                leaves[i] = m
        snap, live, peak = rec.snapshot(), rec.live, rec.peak
        rec.peak = live
        out = run(fn, *tree_unflatten(leaves, spec))
        entry["fwd"] = rec.delta(snap)
        entry["fwd_excess"] = rec.peak - live
        rec.peak = max(peak, rec.peak)
        outs, entry["spec"] = tree_flatten(out)
        tensors = [i for i, o in enumerate(outs)
                   if isinstance(o, torch.Tensor)]
        entry["outs"] = [(outs[i].shape, outs[i].dtype, outs[i].device)
                         for i in tensors]
        entry["consts"] = [None if isinstance(o, torch.Tensor) else o
                           for o in outs]
        # the inputs found must be what the trip's gradients reach: else
        # this signature runs every trip
        entry["replay"] = bool(grad_in) == any(
            outs[i].requires_grad for i in tensors)
        if grad_in and tensors and entry["replay"]:
            marked = _StartMark.apply(entry, rec, *(outs[i] for i in tensors))
            for i, m in zip(tensors, marked):
                outs[i] = m
        self.entries[key] = entry
        self.ran += 1
        return tree_unflatten(outs, entry["spec"])

    def check(self):
        """Every replayed trip's backward was counted."""
        left = sum(len(e["pending"]) for e in self.entries.values())
        if left:
            raise RuntimeError(f"{left} replayed trips' backward costs "
                               f"were never measured")


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_global: float
    bytes_global: float
    coll_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    note: str = ""

    def row(self):
        return (f"| {self.arch} | {self.shape} | {self.mesh} "
                f"| {self.compute_s:.3e} | {self.memory_s:.3e} "
                f"| {self.collective_s:.3e} | {self.dominant} "
                f"| {self.model_flops:.3e} | {self.useful_ratio:.2f} "
                f"| {self.note} |")


def cost_analysis(cell, mesh) -> dict:
    """Trace ``cell`` on ``mesh`` (:func:`~repro_torch.launch.cells.
    trace_cell`) and return rank 0's ``flops``, ``bytes accessed``,
    ``argument_bytes``, ``output_bytes``, ``peak_bytes``, its
    ``collectives`` (kind -> ring bytes, and ``seconds`` at the links'
    rates), the ops made ``Replicate()`` for DTensor, and the trace's
    wall time."""
    from repro_torch.launch.cells import trace_cell
    return trace_cell(cell, mesh)


def terms_of(cost: dict, meta: dict, *, arch: str, shape: str,
             mesh_name: str, chips: int, note: str = "") -> RooflineTerms:
    """The three roofline terms of a :func:`cost_analysis` result."""
    flops, bytes_ = cost["flops"], cost["bytes accessed"]
    peak = PEAK_FLOPS[meta.get("compute_dtype", torch.float32)]
    compute_s = flops / peak
    memory_s = bytes_ / HBM_BW
    collective_s = cost["collectives"]["seconds"]
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    model_flops = float(meta.get("model_flops", 0.0))
    flops_global = flops * chips
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_global=flops_global, bytes_global=bytes_ * chips,
        coll_bytes_per_dev=cost["collectives"]["total"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        useful_ratio=model_flops / flops_global if flops_global else 0.0,
        note=note)


def analyze_cell(arch_id: str, shape_id: str, mesh, mesh_name: str, *,
                 note: str = "", config_patch=None) -> RooflineTerms:
    """The three roofline terms of one cell on one mesh, every cell traced
    once at its full size.  ``config_patch``: ``dataclasses.replace``
    overrides (for the readability cells, ``make_cell``'s keywords)."""
    from repro_torch.launch.cells import make_cell

    cell = make_cell(arch_id, shape_id, mesh, config_patch=config_patch)
    cost = cost_analysis(cell, mesh)
    return terms_of(cost, cell.meta, arch=arch_id, shape=shape_id,
                    mesh_name=mesh_name, chips=mesh.size(), note=note)


HEADER = ("| arch | shape | mesh | compute_s | memory_s | collective_s "
          "| dominant | model_flops | useful | note |\n"
          "|---|---|---|---|---|---|---|---|---|---|")
