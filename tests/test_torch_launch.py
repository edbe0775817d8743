"""The port's sharded train step (repro_torch.launch + train on
torch.distributed) against the JAX package's, and ``launch.train``.

One gloo world of 8 ranks (data 2 x model 4, one spawn, in a subprocess)
trains the four reduced archs of ``test_sharding_multidevice.py`` for two
steps from one numpy tree: at ``grad_accum=1`` held against the JAX
sharded step (8 fake devices on a mesh with ``Auto`` axes: ``make_host_mesh``
gives ``Explicit`` axes under jax 0.9, where ``make_constrain`` raises), at
``grad_accum=2`` against the single-device JAX step (the sharded one meets
the ``lax.scan`` fault, ROADMAP Queue 3). The same world checks that the
MoE drops under data parallelism are those of one device and runs the int8
TP all-reduce. The three subprocesses run side by side."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax  # noqa: F401  (each port test file runs beside JAX)
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import RunPolicy, load_jax_params, numpy_params
from repro_torch.models.moe import moe_kept

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["yi-6b", "olmoe-1b-7b", "rwkv6-1.6b", "recurrentgemma-2b"]
D, M, B, S, STEPS = 2, 4, 4, 16, 2
TC = dict(total_steps=10, warmup_steps=2)
RTOL = 1e-5   # loss and grad norm, relative; params of max |param| ...
ILL = 1e-6    # ... where JAX's sqrt(v_hat) >= 100 eps (test_torch_train.py)
MOE_CF = 0.5  # capacity factor at which the reduced olmoe drops

_COMMON = textwrap.dedent("""
    import json, sys
    import numpy as np
    ARCHS = %(archs)r
    D, M, B, S, STEPS = %(d)d, %(m)d, %(b)d, %(s)d, %(steps)d
    TC = %(tc)r
    out = sys.argv[1]

    def batches(cfg):
        from repro_torch.data import SyntheticLM
        ds = SyntheticLM(cfg.vocab_size, S, B, seed=0, mean_doc_len=8,
                         emb_dim=cfg.d_model if cfg.input_kind == "embeddings" else 0)
        return [ds.batch(i) for i in range(STEPS)]

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k in sorted(tree) for k2, v2 in flat(tree[k], f"{prefix}{k}/").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flat(v, f"{prefix}{i}/").items()}
        return {prefix[:-1]: np.array(tree)}  # a copy: params change in place
""")

_PORT = _COMMON + textwrap.dedent("""
    import torch
    import torch.multiprocessing as mp

    def rank(r, port):
        torch.set_num_threads(1)
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import start_world, end_world, make_host_mesh
        from repro_torch.launch.sharding import (gather_tree, make_run_policy,
                                                 shard_model_)
        from repro_torch.models import load_jax_params, numpy_params
        from repro_torch.models.moe import moe_kept
        from repro_torch.models.parallel import all_gather
        from repro_torch.train import TrainerConfig, make_train_state, make_train_step
        start_world(r, D * M, backend="gloo", port=port)
        mesh = make_host_mesh(D, M)
        res = {}
        for arch in ARCHS:
            cfg = get_config(arch).reduced()
            for accum in (1, 2):
                model = load_jax_params(cfg, numpy_params(cfg, 0, tp=M), "cpu", tp=M)
                shard_model_(model, mesh)
                st = make_train_state(cfg, model)
                step = make_train_step(cfg, make_run_policy(mesh, remat=True),
                                       TrainerConfig(grad_accum=accum, tp=M, **TC))
                ms, arrays = [], {}
                for t, (toks, labels) in enumerate(batches(cfg), 1):
                    st, m = step(st, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)})
                    ms.append([float(m["loss"]), float(m["grad_norm"])])
                    full = gather_tree(st["params"], model.param_specs, mesh)
                    arrays.update({f"{t}/{k}": v for k, v in flat(full).items()})
                res[f"{arch}/{accum}"] = ms
                if r == 0:
                    np.savez(f"{out}/port_{arch}_{accum}.npz", **arrays)
        # MoE drops under DP 2 x TP 4: this data rank's rows of one batch
        cfg = get_config("olmoe-1b-7b").reduced()
        model = load_jax_params(cfg, numpy_params(cfg, 0, tp=M), "cpu", tp=M)
        shard_model_(model, mesh)
        x = torch.from_numpy(np.load(out + "/moe_x.npy"))
        rows = x.shape[0] // D
        pol = make_run_policy(mesh)
        pol.moe_capacity_factor = %(cf)r
        ffn = model.layers[0].ffn
        kept = moe_kept(cfg, ffn.params(), x[mesh.dp.rank * rows:][:rows], pol, tp=M)
        kept = all_gather(kept, 0, mesh.dp)
        # the int8 TP all-reduce on the mesh (inference): logits of a prefill
        toks = torch.from_numpy(batches(get_config("yi-6b").reduced())[0][0])
        ycfg = get_config("yi-6b").reduced()
        ym = load_jax_params(ycfg, numpy_params(ycfg, 0, tp=M), "cpu", tp=M)
        shard_model_(ym, mesh)
        rows = toks.shape[0] // D
        mine = toks[mesh.dp.rank * rows:][:rows]
        exact, _ = ym.prefill(mine, make_run_policy(mesh))
        q8, _ = ym.prefill(mine, make_run_policy(mesh, quantize_tp_collectives=True))
        if r == 0:
            np.save(out + "/moe_kept.npy", kept.numpy())
            res["q8_max_err"] = float((q8 - exact).abs().max())
            res["q8_scale"] = float(exact.abs().max())
            json.dump(res, open(out + "/port.json", "w"))
        end_world()

    if __name__ == "__main__":
        from repro_torch.launch.mesh import free_port
        mp.spawn(rank, args=(free_port(),), nprocs=D * M)
""")

_JAX_SHARDED = _COMMON + textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.sharding import make_run_policy, param_specs
    from repro.launch.steps import _named
    from repro.train import TrainerConfig, make_train_state, make_train_step
    from repro_torch.models import numpy_params
    from repro_torch.configs import get_config as port_config
    mesh = jax.make_mesh((D, M), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    res = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = jax.tree.map(jnp.asarray, numpy_params(port_config(arch).reduced(), 0, tp=M))
        params = jax.device_put(params, _named(mesh, param_specs(params, mesh)))
        state = make_train_state(cfg, params)
        step = jax.jit(make_train_step(cfg, make_run_policy(mesh, remat=True),
                                       TrainerConfig(grad_accum=1, tp=M, **TC)))
        ms, arrays = [], {}
        for t, (toks, labels) in enumerate(batches(cfg), 1):
            batch = jax.device_put({"tokens": toks, "labels": labels},
                                   NamedSharding(mesh, P("data")))
            state, m = step(state, batch)
            ms.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
            arrays.update({f"{t}/{k}": v for k, v in flat(state["params"]).items()})
            arrays.update({f"{t}/v/{k}": v for k, v in flat(state["opt"]["v"]).items()})
        res[arch] = ms
        np.savez(f"{out}/jax_{arch}_1.npz", **arrays)
    json.dump(res, open(out + "/jax_sharded.json", "w"))
""")

_JAX_SINGLE = _COMMON + textwrap.dedent("""
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models.layers import RunPolicy
    from repro.models.transformer import set_policy_tp
    from repro.train import TrainerConfig, make_train_state, make_train_step
    from repro_torch.models import numpy_params
    from repro_torch.configs import get_config as port_config
    res = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = jax.tree.map(jnp.asarray, numpy_params(port_config(arch).reduced(), 0, tp=M))
        pol = set_policy_tp(RunPolicy(remat=True), M)
        for accum in (1, 2):
            state = make_train_state(cfg, params)
            step = jax.jit(make_train_step(cfg, pol, TrainerConfig(grad_accum=accum, tp=M, **TC)))
            ms, arrays = [], {}
            for t, (toks, labels) in enumerate(batches(cfg), 1):
                state, m = step(state, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
                ms.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
                arrays.update({f"{t}/{k}": v for k, v in flat(state["params"]).items()})
                arrays.update({f"{t}/v/{k}": v for k, v in flat(state["opt"]["v"]).items()})
            res[f"{arch}/{accum}"] = ms
            if accum == 2:
                np.savez(f"{out}/jax_{arch}_2.npz", **arrays)
    json.dump(res, open(out + "/jax_single.json", "w"))
""")


def _moe_x():
    cfg = get_config("olmoe-1b-7b").reduced()
    return np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch")
    np.save(out / "moe_x.npy", _moe_x())
    fill = dict(archs=ARCHS, d=D, m=M, b=B, s=S, steps=STEPS, tc=TC, cf=MOE_CF)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for name, code in (("port_side", _PORT), ("jax_sharded", _JAX_SHARDED),
                       ("jax_single", _JAX_SINGLE)):
        (out / f"{name}.py").write_text(code % fill)
        procs[name] = subprocess.Popen(
            [sys.executable, str(out / f"{name}.py"), str(out)], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs["cli"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b",
         "--reduced", "--steps", "2", "--batch", "4", "--seq", "16",
         "--data", "2", "--model", "2", "--device", "cpu"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = {}
    for name, p in procs.items():
        stdout, err = p.communicate(timeout=600)
        done[name] = (p.returncode, stdout, err)
    for name in ("port_side", "jax_sharded", "jax_single"):
        assert done[name][0] == 0, (name, done[name][2][-3000:])
    return out, done


def _assert_close(port_ms, jax_ms, port_npz, jax_npz, spread=None, wd=0.1,
                  b2=0.95):
    """Losses and grad norms to RTOL; each step's params to RTOL of max
    |param| where JAX's update is well conditioned at every step so far,
    to the AdamW bound 2 (1 + wd) sum(lr) elsewhere. ``spread``: per step,
    the relative difference of the reference's own grad norms between its
    sharded and single-device steps, added to RTOL where it exceeds it
    (rwkv6: 3.3e-5 at step 1; its wkv backward rounds by the layout)."""
    for t, ((pl, pg), (jl, jg, _)) in enumerate(zip(port_ms, jax_ms)):
        np.testing.assert_allclose(pl, jl, rtol=RTOL)
        extra = spread[t] if spread is not None and spread[t] > RTOL else 0.0
        np.testing.assert_allclose(pg, jg, rtol=RTOL + extra)
    ill, n_ill, n = {}, 0, 0
    for t in range(1, STEPS + 1):
        keys = [k[len(f"{t}/"):] for k in jax_npz.files
                if k.startswith(f"{t}/") and not k.startswith(f"{t}/v/")]
        assert sorted(keys) == sorted(k[len(f"{t}/"):] for k in port_npz.files
                                      if k.startswith(f"{t}/"))
        tol = RTOL * max(float(np.abs(jax_npz[f"{t}/{k}"]).max()) for k in keys)
        lr_sum = sum(m[2] for m in jax_ms[:t])
        for k in keys:
            v_hat = jax_npz[f"{t}/v/{k}"] / (1 - b2 ** t)
            ill[k] = ill.get(k, False) | (np.sqrt(v_hat) < ILL)
            d = np.abs(port_npz[f"{t}/{k}"] - jax_npz[f"{t}/{k}"])
            assert d[~ill[k]].max(initial=0) <= tol, (t, k)
            assert d[ill[k]].max(initial=0) <= 2 * (1 + wd) * lr_sum + tol
    n_ill = sum(int(m.sum()) for m in ill.values())
    n = sum(m.size for m in ill.values())
    assert n_ill < 0.2 * n


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax_sharded_step(runs, arch):
    out, _ = runs
    port = json.loads((out / "port.json").read_text())
    jax_ms = json.loads((out / "jax_sharded.json").read_text())[arch]
    single = json.loads((out / "jax_single.json").read_text())[f"{arch}/1"]
    spread = [abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(jax_ms, single)]
    _assert_close(port[f"{arch}/1"], jax_ms, np.load(out / f"port_{arch}_1.npz"),
                  np.load(out / f"jax_{arch}_1.npz"), spread)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_accum2_matches_jax_single_device(runs, arch):
    out, _ = runs
    port = json.loads((out / "port.json").read_text())
    jax_ms = json.loads((out / "jax_single.json").read_text())[f"{arch}/2"]
    _assert_close(port[f"{arch}/2"], jax_ms, np.load(out / f"port_{arch}_2.npz"),
                  np.load(out / f"jax_{arch}_2.npz"))


def test_moe_drops_bit_equal_under_dp(runs):
    """Capacity from the global token count and queue positions over the
    global batch: the kept routings of the 2 x 4 world are those of one
    device, and some are dropped."""
    out, _ = runs
    cfg = get_config("olmoe-1b-7b").reduced()
    model = load_jax_params(cfg, numpy_params(cfg, 0, tp=M), "cpu", tp=M)
    want = moe_kept(cfg, model.layers[0].ffn.params(), torch.from_numpy(_moe_x()),
                    RunPolicy(moe_capacity_factor=MOE_CF), tp=M)
    got = np.load(out / "moe_kept.npy")
    np.testing.assert_array_equal(got, want.numpy())
    assert not want.all() and want.any()


def test_q8_collectives_run_on_a_mesh(runs):
    """``quantize_tp_collectives`` with a mesh runs the int8 all-reduce
    (no NotImplementedError) and stays near the exact logits."""
    out, _ = runs
    port = json.loads((out / "port.json").read_text())
    assert 0 < port["q8_max_err"] <= 0.05 * port["q8_scale"]


def test_launch_train_on_data2_model2_cpu(runs):
    _, done = runs
    rc, stdout, err = done["cli"]
    assert rc == 0, err[-3000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith("arch=")]
    assert len(line) == 1, stdout
    assert line[0].startswith("arch=yi-6b steps=2 restarts=0 first_loss=")
    assert "last_loss=" in line[0] and line[0].endswith("s")


def test_sharded_step_needs_a_model_sharded_on_the_policys_mesh():
    """The sharded step takes its mesh from the policy alone and refuses,
    before any work, a model that ``shard_model_`` did not cut on it."""
    from types import SimpleNamespace

    from repro_torch.models import init_params
    from repro_torch.models.parallel import Axis
    from repro_torch.train import TrainerConfig, make_train_state, make_train_step

    cfg = get_config("yi-6b").reduced()
    one = Axis(None, 1, 0)
    mesh = SimpleNamespace(dp=one, tp=one)
    model = init_params(cfg, seed=0, device="cpu")
    state = make_train_state(cfg, model)
    step = make_train_step(cfg, RunPolicy(mesh=mesh), TrainerConfig())
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.zeros((2, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="not sharded on the policy's mesh"):
        step(state, batch)
    model.mesh = SimpleNamespace(dp=one, tp=one)  # another mesh
    with pytest.raises(ValueError, match="not sharded on the policy's mesh"):
        step(state, batch)
