"""The port's config, cache-key and validation machinery against the
reference: ``EvalConfig`` canonicalization, ``repr`` and ``digest()``;
``pow2_bucket`` / ``pow2_chunks`` / ``topology_hash``; ``DEFAULT_IDEAL``;
and ``validate_request`` / ``validate_batch``, whose outputs must be
byte-identical with equal flags and error messages.  Everything compared
here is host-side and exact: no tolerance.
"""

import math

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro.core import engine as ref_engine
from repro.core import keys as ref_keys
from repro.core import validate as ref_validate
from repro_torch.core import engine as t_engine
from repro_torch.core import keys as t_keys
from repro_torch.core import validate as t_validate

CONFIGS = [
    {},
    dict(radius=2, n_strips=32),
    dict(orientation="vertical", metrics=("edge_crossing",)),
    dict(orientation="horizontal", metrics="node_occlusion"),
    dict(metrics=("edge_crossing_angle", "node_occlusion", "minimum_angle")),
    dict(ideal_angle=None, tier_strips=True),
    dict(ideal_angle=1.0, tier_strips=False, cell_block=128.0,
         strip_block=64),
    dict(backend="kernels", validation="sanitize"),
    dict(backend="eager", validation="off", temperature=0.5),
    dict(backend="distributed", shards=2.0),
    dict(backend="graph_sharded", shards=4, precision="bfloat16"),
    dict(radius=np.float32(0.25), n_strips=np.int64(512)),
]

BAD_CONFIGS = [
    dict(orientation="diagonal"), dict(backend="tpu"),
    dict(precision="float16"), dict(validation="lenient"),
    dict(metrics=("edge_crossing", "bogus")), dict(metrics=()),
    dict(shards=0), dict(temperature=0.0),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_repr_digest_equal(kw):
    ref = ref_keys.EvalConfig(**kw)
    got = t_keys.EvalConfig(**kw)
    assert repr(got) == repr(ref)
    assert got.digest() == ref.digest()
    assert got.plan_kwargs() == ref.plan_kwargs()
    assert (got.plan_kwargs(tier_default=False)
            == ref.plan_kwargs(tier_default=False))
    assert got.use_kernels == ref.use_kernels


def test_default_digest_is_the_reference_constant():
    assert t_keys.EvalConfig().digest() == "e6398fe2fb3e0f02e5559570"
    assert ref_keys.EvalConfig().digest() == "e6398fe2fb3e0f02e5559570"


@pytest.mark.parametrize("kw", BAD_CONFIGS)
def test_bad_configs_raise_alike(kw):
    with pytest.raises(ValueError) as ref_err:
        ref_keys.EvalConfig(**kw)
    with pytest.raises(ValueError) as got_err:
        t_keys.EvalConfig(**kw)
    assert str(got_err.value) == str(ref_err.value)


def test_default_ideal_bit_equal():
    assert t_engine.DEFAULT_IDEAL == ref_engine.DEFAULT_IDEAL
    assert (np.float32(t_engine.DEFAULT_IDEAL).tobytes()
            == np.float32(ref_engine.DEFAULT_IDEAL).tobytes())
    assert t_engine.DEFAULT_IDEAL == 1.2217304706573486
    assert t_engine.ALL_METRICS == ref_engine.ALL_METRICS


@given(st.integers(0, 1 << 20), st.sampled_from([1, 64, 128, 1000]))
@settings(max_examples=60, deadline=None)
def test_pow2_bucket_equal(n, floor):
    assert t_keys.pow2_bucket(n, floor) == ref_keys.pow2_bucket(n, floor)


@given(st.integers(0, 70), st.sampled_from([1, 2, 3, 8, 32]))
@settings(max_examples=60, deadline=None)
def test_pow2_chunks_equal(n, max_chunk):
    items = list(range(n))
    assert (t_keys.pow2_chunks(items, max_chunk)
            == ref_keys.pow2_chunks(items, max_chunk))


@pytest.mark.parametrize("seed", range(4))
def test_topology_hash_equal(seed):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, 50, size=(int(rng.integers(0, 40)), 2))
    n_v = int(rng.integers(1, 100))
    assert (t_keys.topology_hash(edges, n_v)
            == ref_keys.topology_hash(edges, n_v))


# ---------------------------------------------------------------------------
# validation: byte-identical outputs, equal flags, equal typed errors
# ---------------------------------------------------------------------------

# non-finite values drawn through a valid strategy (bounded floats with
# allow_nan is an invalid hypothesis argument combination)
_coord = st.one_of(st.floats(-100, 100),
                   st.sampled_from([math.nan, math.inf, -math.inf]))


@st.composite
def _request(draw):
    n_v = draw(st.integers(0, 12))
    pos = np.array(draw(st.lists(st.tuples(_coord, _coord), min_size=n_v,
                                 max_size=n_v)), np.float64).reshape(n_v, 2)
    n_e = draw(st.integers(0, 16))
    edges = np.array(draw(st.lists(st.tuples(st.integers(-2, n_v + 2),
                                             st.integers(-2, n_v + 2)),
                                   min_size=n_e, max_size=n_e)),
                     np.int64).reshape(n_e, 2)
    return pos, edges


def _outcome(fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except ref_validate.ReadabilityError as err:
        return ("error", type(err).__name__, str(err),
                getattr(err, "reason", None), err.request_index)
    except t_validate.ReadabilityError as err:
        return ("error", type(err).__name__, str(err),
                getattr(err, "reason", None), err.request_index)
    pos, edges, flags = out
    pos, edges = np.asarray(pos), np.asarray(edges)
    return ("ok", pos.dtype.str, pos.shape, pos.tobytes(), edges.dtype.str,
            edges.shape, edges.tobytes(), flags)


@given(_request(), st.sampled_from(["strict", "sanitize", "off"]),
       st.sampled_from([None, 3]))
@settings(max_examples=120, deadline=None)
def test_validate_request_byte_identical(req, mode, index):
    pos, edges = req
    ref = _outcome(ref_validate.validate_request, pos, edges, mode=mode,
                   index=index)
    got = _outcome(t_validate.validate_request, pos, edges, mode=mode,
                   index=index)
    assert got == ref


@given(st.integers(1, 3), _request(),
       st.sampled_from(["strict", "sanitize", "off"]))
@settings(max_examples=80, deadline=None)
def test_validate_batch_byte_identical(b, req, mode):
    pos, edges = req
    batch = np.stack([pos + i for i in range(b)])
    ref = _outcome(ref_validate.validate_batch, batch, edges, mode=mode)
    got = _outcome(t_validate.validate_batch, batch, edges, mode=mode)
    assert got == ref


@pytest.mark.parametrize("bad", [np.zeros((3, 3)), [[0.5, 1.0]] * 2])
def test_uninterpretable_requests_raise_alike(bad):
    pos = np.zeros((4, 2))
    ref = _outcome(ref_validate.validate_request, pos, bad)
    got = _outcome(t_validate.validate_request, pos, bad)
    assert got == ref and got[0] == "error"
