"""The port's sharding rules (repro_torch.launch.sharding) and config
helpers against the JAX package's: param, optimizer, cache and batch specs
for all ten archs at full width on the (16, 16), (2, 16, 16) and (2, 4)
meshes; tp_shard_nodes; attention_free / sub_quadratic /
active_param_count / cells / input_specs."""
from types import SimpleNamespace

import jax  # noqa: F401  (each port test file runs beside JAX)
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cells as jax_cells
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs import list_archs
from repro.launch import sharding as jsh
from repro.models.cache import cache_specs as jax_cache_specs
from repro.models.transformer import init_params_specs as jax_params_specs
from repro_torch.configs import SHAPES, cells, get_config, input_specs
from repro_torch.launch import sharding as sh
from repro_torch.models import parallel
from repro_torch.models.cache import init_cache
from repro_torch.models.transformer import init_params_specs

MESHES = {
    "16x16": SimpleNamespace(shape={"data": 16, "model": 16},
                             axis_names=("data", "model")),
    "2x16x16": SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                               axis_names=("pod", "data", "model")),
    "2x4": SimpleNamespace(shape={"data": 2, "model": 4},
                           axis_names=("data", "model")),
}


def _flat(tree, prefix=""):
    """{path: spec as a tuple} of a JAX PartitionSpec tree or the port's."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tuple(tree)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_specs_match_jax(arch, mesh_name):
    mesh = MESHES[mesh_name]
    tp = mesh.shape["model"]
    jshape = jax_params_specs(jax_get_config(arch), tp=tp)
    pshape = init_params_specs(get_config(arch), tp=tp)
    jp = jsh.param_specs(jshape, mesh)
    pp = sh.param_specs(pshape, mesh)
    assert _flat(pp) == _flat(jp)
    # the shapes the rules read are the same
    assert ({k: tuple(v.shape) for k, v in _flat_leaves(pshape).items()}
            == {k: tuple(v.shape) for k, v in _flat_leaves(jshape).items()})
    jo = jsh.opt_specs(jp, jshape, mesh)
    po = sh.opt_specs(pp, pshape, mesh)
    for k in ("m", "v", "master"):
        assert _flat(po[k]) == _flat(jo[k])
    assert tuple(po["count"]) == tuple(jo["count"]) == ()
    # some dim of a large arch is sharded, and the guard replicates some
    flat = _flat(pp)
    assert any("model" in s for s in flat.values())


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_leaves(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_jax(arch, mesh_name):
    mesh = MESHES[mesh_name]
    tp = mesh.shape["model"]
    cfg = get_config(arch)
    for B, S, quant in ((128, 1024, False), (1, 2048, False), (32, 512, True)):
        jc = jax_cache_specs(jax_get_config(arch), B, S, tp=tp, kv_quant=quant)
        pc = init_cache(cfg, B, S, tp=tp, kv_quant=quant, device="meta")
        assert ({k: tuple(v.shape) for k, v in _flat_leaves(pc).items()}
                == {k: tuple(v.shape) for k, v in _flat_leaves(jc).items()})
        assert ({k: str(v.dtype).split(".")[-1] for k, v in _flat_leaves(pc).items()}
                == {k: str(v.dtype) for k, v in _flat_leaves(jc).items()})
        assert (_flat(sh.cache_specs_tree(pc, mesh, B))
                == _flat(jsh.cache_specs_tree(jc, mesh, B)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_spec_matches_jax(mesh_name):
    mesh = MESHES[mesh_name]
    for ndim in (1, 2, 3):
        for B in (1, 2, 3, 4, 16, 32, 100, 256, 512):  # some not divisible
            assert (sh.batch_spec(mesh, ndim=ndim, batch_size=B)
                    == tuple(jsh.batch_spec(mesh, ndim=ndim, batch_size=B)))
    assert sh.batch_spec(mesh, ndim=2, batch_size=1) == (None, None)


def test_tp_shard_nodes_match_jax():
    for tp in range(1, 17):
        for nodes in range(1, 5):
            assert sh.tp_shard_nodes(tp, nodes) == jsh.tp_shard_nodes(tp, nodes)
    with pytest.raises(ValueError):
        sh.tp_shard_nodes(0, 1)


@pytest.mark.parametrize("arch", list_archs())
def test_config_helpers_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.attention_free == jcfg.attention_free
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.param_count() == jcfg.param_count()
    for name, shape in SHAPES.items():
        got = input_specs(cfg, shape, tp=16)
        want = jax_input_specs(jcfg, JAX_SHAPES[name], tp=16)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if k == "micro_batch":
                assert got[k] == v
            elif k == "cache":
                assert ({p: tuple(t.shape) for p, t in _flat_leaves(got[k]).items()}
                        == {p: tuple(t.shape) for p, t in _flat_leaves(v).items()})
            else:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(v.shape)
                assert str(got[k].dtype).split(".")[-1] == str(v.dtype)


def test_cells_match_jax():
    assert cells() == jax_cells()
    assert cells(include_skipped=True) == jax_cells(include_skipped=True)
    assert len(cells()) == 32 and len(cells(include_skipped=True)) == 40


def test_local_chunk_and_gather_of_one_rank():
    """A one-rank view of the (2, 4) mesh: ``models.parallel.local_chunk``
    (the spec helpers the trainer and the launch layer share) takes the rank's
    block of each sharded dim (the first axis of a tuple major)."""
    mesh = SimpleNamespace(shape={"pod": 2, "data": 2, "model": 4},
                           axis_names=("pod", "data", "model"),
                           coordinate={"pod": 1, "data": 0, "model": 3})
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    got = parallel.local_chunk(t, (("pod", "data"), "model"), mesh)
    np.testing.assert_array_equal(got.numpy(), t[4:6, 9:12].numpy())
    assert parallel.zero_dim((None, "model"), ("data", "model")) == 0
    assert parallel.zero_dim(("model",), ("model",)) is None
