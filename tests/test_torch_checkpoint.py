"""The port's checkpoints (repro_torch.checkpoint) in the JAX package's
on-disk format: one numpy train state saved by both managers gives the same
manifest; each package restores the other's checkpoint; the corruption,
pruning and atomicity tests of tests/test_fault_tolerance.py on the port."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.train import make_train_state as jax_make_train_state
from repro_torch.checkpoint import CheckpointCorruptError, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.models import numpy_params
from repro_torch.models.convert import load_jax_train_state, numpy_train_state
from repro_torch.runtime import reshard_tree
from repro_torch.tree import flatten, tree_map


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(arch="yi-6b", seed=0):
    """The JAX train state and the port's, from one numpy state whose
    moments are not zero."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jstate = jax_make_train_state(jcfg, jax.tree.map(jnp.asarray,
                                                     numpy_params(cfg, seed)))
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(np.asarray, jstate)
    for k in ("m", "v"):
        tree["opt"][k] = jax.tree.map(
            lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32),
            tree["opt"][k])
    tree["opt"]["count"] = np.int32(5)
    tree["step"] = np.int32(5)
    jstate = jax.tree.map(jnp.asarray, tree)
    return jstate, load_jax_train_state(cfg, tree, "cpu")


def _numpy(tree):
    return tree_map(lambda t: t.numpy(), tree)


def _equal_trees(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b", "recurrentgemma-2b"])
def test_both_managers_write_the_same_manifest(arch, tmp_path):
    jstate, state = _states(arch)
    JaxCheckpointManager(str(tmp_path / "jax"), async_save=False).save(5, jstate)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(5, state)
    man = [json.loads((tmp_path / d / "step-000000005" / "manifest.json")
                      .read_text()) for d in ("jax", "port")]
    assert man[0] == man[1]
    assert man[1]["keys"]["opt/count"] == man[0]["keys"]["opt/count"]
    assert man[1]["keys"]["step"]["dtype"] == "int32"
    assert any(k.startswith("opt/master/layers/0/") for k in man[1]["keys"])


def test_a_jax_checkpoint_restores_into_the_port(tmp_path):
    jstate, state = _states()
    JaxCheckpointManager(str(tmp_path), async_save=False).save(5, jstate)
    step, tree = CheckpointManager(str(tmp_path)).restore(state)
    assert step == 5
    assert isinstance(flatten(tree)["params/embed/w"], torch.Tensor)
    _equal_trees(jax.tree.map(np.asarray, jstate), _numpy(tree))


def test_a_port_checkpoint_restores_into_jax(tmp_path):
    jstate, state = _states()
    cm = CheckpointManager(str(tmp_path), async_save=True)
    cm.save(5, state)
    cm.wait()
    mgr = JaxCheckpointManager(str(tmp_path))
    step, tree = mgr.restore(jstate)
    assert step == 5
    _equal_trees(jax.tree.map(np.asarray, tree), numpy_train_state(state))


def test_checkpoint_roundtrip_and_reshard(tmp_path):
    """test_checkpoint_roundtrip / test_elastic_reshard_across_device_counts:
    save, restore onto a device, then a live move through the host."""
    _, state = _states("olmoe-1b-7b")
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(7, state)
    step, restored = cm.restore(state, device="cpu")
    assert step == 7
    _equal_trees(numpy_train_state(state), _numpy(restored))
    _equal_trees(_numpy(reshard_tree(restored, device="cpu")), _numpy(restored))


def test_async_save_snapshots_the_state_at_save_time(tmp_path):
    """The async writer works on a host copy: an in-place update right after
    ``save`` does not reach the checkpoint."""
    _, state = _states()
    cm = CheckpointManager(str(tmp_path), async_save=True)
    before = numpy_train_state(state)
    cm.save(1, state)
    with torch.no_grad():
        state["params"]["embed"]["w"].add_(1.0)
    cm.wait()
    _, tree = cm.restore(state)
    _equal_trees(before, _numpy(tree))


def test_keep_last_pruning_and_atomicity(tmp_path):
    _, state = _states()
    cm = CheckpointManager(str(tmp_path), keep_last=2, async_save=False)
    for s in (1, 2, 3, 4):
        cm.save(s, state)
    assert cm.all_steps() == [3, 4]
    assert not any(d.startswith(".tmp") for d in os.listdir(tmp_path))


def test_restore_rejects_truncated_archive(tmp_path):
    _, state = _states()
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(3, state)
    npz = tmp_path / "step-000000003" / "tensors.npz"
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.raises(CheckpointCorruptError):
        cm.restore(state)


def test_restore_rejects_flipped_tensor_bytes(tmp_path):
    _, state = _states()
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(5, state)
    npz = str(tmp_path / "step-000000005" / "tensors.npz")
    with np.load(npz) as z:
        flat = {k: np.array(z[k]) for k in z.files}
    victim = sorted(flat)[0]
    flat[victim].reshape(-1).view(np.uint8)[0] ^= 0xFF
    np.savez(npz, **flat)
    with pytest.raises(CheckpointCorruptError, match="crc32"):
        cm.restore(state)
    cm.save(6, state)
    step, _ = cm.restore(state)
    assert step == 6


def test_restore_rejects_a_missing_tensor(tmp_path):
    _, state = _states()
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(2, state)
    npz = str(tmp_path / "step-000000002" / "tensors.npz")
    with np.load(npz) as z:
        flat = {k: np.array(z[k]) for k in z.files if k != "step"}
    np.savez(npz, **flat)
    with pytest.raises(CheckpointCorruptError, match="missing"):
        cm.restore(state)


def test_restore_without_crc_still_checks_structure(tmp_path):
    _, state = _states()
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(1, state)
    man = tmp_path / "step-000000001" / "manifest.json"
    manifest = json.loads(man.read_text())
    for meta in manifest["keys"].values():
        meta.pop("crc32")
    man.write_text(json.dumps(manifest))
    step, _ = cm.restore(state)
    assert step == 1
    victim = sorted(manifest["keys"])[0]
    manifest["keys"][victim]["shape"] = [1, 2, 3]
    man.write_text(json.dumps(manifest))
    with pytest.raises(CheckpointCorruptError):
        cm.restore(state)
    manifest["keys"][victim]["shape"] = list(np.shape(
        flatten(numpy_train_state(state))[victim]))
    manifest["keys"][victim]["dtype"] = "float64"
    man.write_text(json.dumps(manifest))
    with pytest.raises(CheckpointCorruptError, match="manifest says"):
        cm.restore(state)
