"""The port's checkpoint stack (``repro_torch.checkpoint.manager``) and
elastic restore (``repro_torch.launch.elastic``) against the reference:
twins of ``tests/test_substrates.py``'s checkpoint cases (save and
restore, a corrupted newest step skipped, garbage collection), the
on-disk format shared with ``repro.checkpoint.manager`` (a training
state written by either package restores in the other to equal
arrays), rank 0 alone writing, and ``elastic_restore`` on one process.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.optim import adamw as ref_adamw
from repro_torch import configs as t_configs
from repro_torch.checkpoint import manager as t_manager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import elastic
from repro_torch.models import transformer as t_tf
from repro_torch.optim import adamw

CPU = torch.device("cpu")


def small_tree():
    return {"layers": [{"w": torch.arange(6.0).reshape(2, 3)}],
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_save_restore_and_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = small_tree()
    mgr.save(1, tree)
    mgr.save(2, {"layers": [{"w": tree["layers"][0]["w"] + 1}],
                 "step": tree["step"] + 1})
    restored, step = mgr.restore(tree, device="cpu")
    assert step == 2
    np.testing.assert_allclose(restored["layers"][0]["w"].numpy(),
                               np.arange(6.0).reshape(2, 3) + 1)
    # corrupt the newest checkpoint -> restore falls back to step 1
    with open(os.path.join(str(tmp_path), "step_000000002", "arrays.npz"),
              "wb") as f:
        f.write(b"garbage")
    assert mgr.latest_valid_step() == 1
    restored, step = mgr.restore(tree, device="cpu")
    assert step == 1
    assert int(restored["step"]) == 7
    assert restored["step"].dtype == torch.int32


@pytest.mark.parametrize("keep", [2, 3])
def test_checkpoint_gc_keeps_newest(tmp_path, keep):
    mgr = CheckpointManager(str(tmp_path), **({} if keep == 3 else
                                              {"keep": keep}))
    assert mgr.keep == keep
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [1, 2, 3, 4][-keep:]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_")]


def test_empty_directory_restores_nothing(tmp_path):
    restored, step = CheckpointManager(str(tmp_path)).restore(
        small_tree(), device="cpu")
    assert restored is None and step is None


def test_manifest_matches_reference_layout(tmp_path):
    """The same tree written by both packages: the same keys, shapes and
    dtypes in the manifest, and payloads with the same arrays."""
    rng = np.random.default_rng(0)
    arrays = {"b": rng.standard_normal((4, 2)).astype(np.float32),
              "a": {"z": rng.integers(0, 9, (3,)).astype(np.int32),
                    "y": [rng.standard_normal(5).astype(np.float32)]}}
    RefManager(str(tmp_path / "ref")).save(5, jax.tree.map(jnp.asarray,
                                                           arrays))
    CheckpointManager(str(tmp_path / "port")).save(5, {
        "b": torch.from_numpy(arrays["b"]),
        "a": {"z": torch.from_numpy(arrays["a"]["z"]),
              "y": [torch.from_numpy(arrays["a"]["y"][0])]}})
    manifests = []
    for side in ("ref", "port"):
        with open(tmp_path / side / "step_000000005" / "manifest.json") as f:
            manifests.append(json.load(f))
    assert manifests[0]["keys"] == manifests[1]["keys"]
    assert set(manifests[0]["keys"]) == {"a/y/0", "a/z", "b"}
    assert manifests[0]["step"] == manifests[1]["step"] == 5


@pytest.fixture(scope="module")
def train_state():
    """A training state of the qwen3-4b smoke config in the reference's
    layout: numpy parameters, AdamW moments, step and data cursor."""
    cfg = t_configs.get_arch("qwen3-4b").smoke_config.with_mesh(1)
    params = t_tf.numpy_params(cfg, 0)
    rng = np.random.default_rng(1)
    moments = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    return cfg, {"params": params,
                 "opt": {"m": moments,
                         "v": jax.tree.map(np.abs, moments),
                         "step": np.int32(3)},
                 "cursor": {"seed": np.int32(0), "step": np.int32(3)}}


def assert_same(port_tree, ref_tree):
    flat_p = t_manager._flatten_with_paths(port_tree)
    flat_r = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(
                  ref_tree)[0]}
    assert flat_p.keys() == flat_r.keys()
    for k in flat_p:
        assert flat_p[k].dtype == flat_r[k].dtype, k
        np.testing.assert_array_equal(flat_p[k], flat_r[k], err_msg=k)


def test_reference_checkpoint_restores_in_port(tmp_path, train_state):
    """A training state written by ``repro.checkpoint.manager`` restores
    in the port into the trainer's template to equal tensors."""
    cfg, state = train_state
    RefManager(str(tmp_path)).save(3, jax.tree.map(jnp.asarray, state))
    model = t_tf.Transformer(cfg, device="cpu")
    template = {"params": model.param_tree(),
                "opt": adamw.init_state(model.param_tree()),
                "cursor": {"seed": torch.tensor(0, dtype=torch.int32),
                           "step": torch.tensor(0, dtype=torch.int32)}}
    restored, step = CheckpointManager(str(tmp_path)).restore(template,
                                                              device="cpu")
    assert step == 3
    assert_same(restored, state)
    with torch.no_grad():
        model.load_state_dict(t_tf.params_from_reference(
            jax.tree.map(np.asarray, state["params"])))
    for k, p in model.state_dict().items():
        leaf = restored["params"]
        for part in k.split("."):
            leaf = leaf[part]
        assert torch.equal(p, leaf), k


def test_port_checkpoint_restores_in_reference(tmp_path, train_state):
    """A training state written by the port (the trainer's tensors)
    restores in ``repro.checkpoint.manager`` to equal arrays."""
    cfg, state = train_state
    port_state = {
        "params": adamw._map(torch.from_numpy, state["params"]),
        "opt": {"m": adamw._map(torch.from_numpy, state["opt"]["m"]),
                "v": adamw._map(torch.from_numpy, state["opt"]["v"]),
                "step": torch.tensor(3, dtype=torch.int32)},
        "cursor": {"seed": torch.tensor(0, dtype=torch.int32),
                   "step": torch.tensor(3, dtype=torch.int32)}}
    CheckpointManager(str(tmp_path)).save(3, port_state)
    ref = RefManager(str(tmp_path))
    assert ref.latest_valid_step() == 3
    restored, step = ref.restore(jax.tree.map(jnp.asarray, state))
    assert step == 3
    assert_same(port_state, restored)


def test_only_rank_zero_writes(tmp_path, monkeypatch):
    """Under a process group only rank 0 writes; the others return the
    step's directory without writing."""
    mgr = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(t_manager.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(t_manager.dist, "get_rank", lambda: 1)
    path = mgr.save(1, small_tree())
    assert path.endswith("step_000000001") and mgr.all_steps() == []
    monkeypatch.setattr(t_manager.dist, "get_rank", lambda: 0)
    mgr.save(1, small_tree())
    assert mgr.all_steps() == [1]


def test_make_elastic_mesh_one_process():
    mesh = elastic.make_elastic_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.axis_shape == elastic.choose_mesh_shape(1) == (1, 1)
    assert mesh.device == CPU and mesh.group is None


def test_elastic_restore_one_process(tmp_path):
    """``elastic_restore`` rebuilds the mesh and restores the newest valid
    step onto the device ``sharding_fn`` names."""
    tree = small_tree()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, tree)
    mgr.save(8, {"layers": [{"w": tree["layers"][0]["w"] * 2}],
                 "step": tree["step"]})
    seen = []

    def sharding_fn(mesh, template):
        seen.append((mesh, template))
        return mesh.device

    restored, step, mesh = elastic.elastic_restore(
        str(tmp_path), tree, sharding_fn, device="cpu")
    assert step == 8 and seen == [(mesh, tree)]
    assert mesh.axis_shape == (1, 1)
    assert torch.equal(restored["layers"][0]["w"], tree["layers"][0]["w"] * 2)
    assert restored["step"].device == CPU
    empty, none, _ = elastic.elastic_restore(str(tmp_path / "none"), tree,
                                             sharding_fn, device="cpu")
    assert empty is None and none is None


def test_elastic_restore_resumes_the_reference_optimizer(tmp_path):
    """AdamW state saved by the reference and restored elastically steps on
    in the port as the reference steps on."""
    params = {"w": jnp.asarray([3.0, -2.0]), "b": jnp.asarray(1.5)}
    cfg_r = ref_adamw.AdamWConfig(peak_lr=0.1, warmup_steps=2,
                                  total_steps=10)
    state = ref_adamw.init_state(params)
    grads = {"w": jnp.asarray([0.5, -1.0]), "b": jnp.asarray(2.0)}
    params, state, _ = ref_adamw.apply_updates(params, grads, state, cfg_r)
    RefManager(str(tmp_path)).save(1, {"params": params, "opt": state})
    template = {"params": {"w": torch.zeros(2), "b": torch.zeros(())},
                "opt": adamw.init_state({"w": torch.zeros(2),
                                         "b": torch.zeros(())})}
    tree, step, _ = elastic.elastic_restore(
        str(tmp_path), template, lambda mesh, t: mesh.device, device="cpu")
    assert step == 1
    want_p, _, _ = ref_adamw.apply_updates(params, grads, state, cfg_r)
    cfg = adamw.AdamWConfig(peak_lr=0.1, warmup_steps=2, total_steps=10)
    adamw.apply_updates_(tree["params"], adamw._map(
        lambda g: torch.tensor(np.asarray(g)), grads), tree["opt"], cfg)
    for k in ("w", "b"):
        np.testing.assert_allclose(tree["params"][k].numpy(),
                                   np.asarray(want_p[k]), rtol=1e-6)
