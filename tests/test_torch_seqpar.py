"""Sequence parallelism of the residual (``RunPolicy.sequence_parallel``) on
the port's torch.distributed launch layer, against the JAX package's
``make_run_policy(mesh, sequence_parallel=True)``.

One gloo world of 8 ranks (data 2 x model 4, in a subprocess) trains the
four reduced archs of ``test_torch_launch.py`` for two steps from one numpy
tree, with and without sequence parallelism; the JAX sharded step with it
runs on 8 fake devices (a mesh of ``Auto`` axes, as in
``test_torch_launch.py``), and its sharded step without it and its
single-device step give the reference's own spread. The same world prefills with and without it
(S 16, split over the 4 model ranks; S 18, which they do not divide), routes
the reduced olmoe's MoE from seq-split positions and runs the int8 TP
all-reduce with it. A second world of 2 ranks holds the three autograd
pairs to one rank's autograd. The four subprocesses run side by side."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax  # noqa: F401  (each port test file runs beside JAX)
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import RunPolicy, load_jax_params, numpy_params
from repro_torch.models.moe import moe_kept
from repro_torch.models.parallel import Axis, seq_axis
from test_torch_launch import (
    ARCHS, B, D, M, MOE_CF, RTOL, S, STEPS, TC, _COMMON, _assert_close, _moe_x)

ROOT = Path(__file__).resolve().parent.parent
PREFILL_S = (16, 18)  # split over the 4 model ranks; not divisible: unsplit
# held to their own unsplit step only: musicgen's embeddings input and
# sinusoidal table, and a starcoder2 whose d_ff and vocab the 4 model ranks
# do not divide (replicated gelu MLP with biases, replicated embedding/head)
OTHER = ["musicgen-medium", "starcoder2-7b/odd"]

_PORT = _COMMON + textwrap.dedent("""
    import torch
    import torch.multiprocessing as mp

    def rank(r, port):
        import dataclasses
        torch.set_num_threads(1)
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import start_world, end_world, make_host_mesh
        from repro_torch.launch.sharding import (gather_tree, make_run_policy,
                                                 shard_model_)
        from repro_torch.models import load_jax_params, numpy_params
        from repro_torch.models.layers import row_parallel
        from repro_torch.models.moe import moe_kept
        from repro_torch.models.parallel import Axis, all_gather, all_reduce_, local_slice
        from repro_torch.train import TrainerConfig, make_train_state, make_train_step
        start_world(r, D * M, backend="gloo", port=port)
        mesh = make_host_mesh(D, M)
        world = Axis(torch.distributed.group.WORLD, D * M, r)

        def worst(*vals):  # the largest of each value over the world
            t = torch.tensor(vals, dtype=torch.float64)
            return all_reduce_(t, world, torch.distributed.ReduceOp.MAX).tolist()

        def config(name):
            arch, _, odd = name.partition("/")
            cfg = get_config(arch).reduced()
            return dataclasses.replace(cfg, d_ff=130, vocab_size=258) if odd else cfg

        def model_of(cfg):
            model = load_jax_params(cfg, numpy_params(cfg, 0, tp=M), "cpu", tp=M)
            shard_model_(model, mesh)
            return model

        def mine(t):  # this data rank's rows
            rows = t.shape[0] // D
            return t[mesh.dp.rank * rows:][:rows]

        res, prefill = {}, {}
        for arch in ARCHS + %(other)r:
            cfg = config(arch)
            for sp in (False, True):
                model = model_of(cfg)
                st = make_train_state(cfg, model)
                pol = make_run_policy(mesh, remat=True, sequence_parallel=sp)
                step = make_train_step(cfg, pol, TrainerConfig(grad_accum=1, tp=M, **TC))
                ms, arrays = [], {}
                for t, (toks, labels) in enumerate(batches(cfg), 1):
                    st, m = step(st, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)})
                    ms.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
                    full = gather_tree(st["params"], model.param_specs, mesh)
                    arrays.update({f"{t}/{k}": v for k, v in flat(full).items()})
                    v = gather_tree(st["opt"]["v"], model.zero_specs, mesh)
                    arrays.update({f"{t}/v/{k}": x for k, x in flat(v).items()})
                res[f"{arch}/{int(sp)}"] = ms
                if r == 0:
                    np.savez(f"{out}/port_{arch.replace('/', '_')}_{int(sp)}.npz",
                             **arrays)
            if arch not in ARCHS:
                continue
            # prefill at S 16 (split) and S 18 (unsplit), this data rank's rows
            model = model_of(cfg)
            rng = np.random.default_rng(11)
            for s in %(prefill_s)r:
                toks = torch.from_numpy(mine(rng.integers(
                    0, cfg.vocab_size, (B, s)).astype(np.int32)))
                outs = [model.prefill(toks, make_run_policy(mesh, sequence_parallel=sp))
                        for sp in (False, True)]
                (la, ca), (lb, cb) = outs
                pairs = [(la, lb)] + [(ca[i][k], cb[i][k])
                                      for i in range(len(ca)) for k in ca[i]]
                vals = worst(float((la - lb).abs().max()), float(la.abs().max()),
                             max(float((a - b).abs().max()) for a, b in pairs[1:]),
                             max(float(a.abs().max()) for a, _ in pairs[1:]),
                             float(not all(torch.equal(a, b) for a, b in pairs)))
                prefill[f"{arch}/{s}"] = dict(zip(
                    ("logit_err", "logit_scale", "cache_err", "cache_scale",
                     "differ"), vals))
        # MoE drops from seq-split positions of this data rank's rows
        cfg = get_config("olmoe-1b-7b").reduced()
        model = model_of(cfg)
        x = mine(torch.from_numpy(np.load(out + "/moe_x.npy")))
        pol = make_run_policy(mesh, sequence_parallel=True)
        pol.moe_capacity_factor = %(cf)r
        kept = moe_kept(cfg, model.layers[0].ffn.params(),
                        local_slice(x, 1, mesh.tp), pol, tp=M, seq=mesh.tp)
        kept = all_gather(kept, 0, mesh.dp)
        # int8 TP all-reduce with sequence parallelism: the logits and caches
        # of the q8 pass without it, and row_parallel's local positions
        ycfg = get_config("yi-6b").reduced()
        ym = model_of(ycfg)
        toks = torch.from_numpy(mine(batches(ycfg)[0][0]))
        q8 = make_run_policy(mesh, quantize_tp_collectives=True)
        q8sp = make_run_policy(mesh, quantize_tp_collectives=True,
                               sequence_parallel=True)
        fa, fb = ym.forward(toks, q8), ym.forward(toks, q8sp)
        (_, ca), (_, cb) = ym.prefill(toks, q8), ym.prefill(toks, q8sp)
        g = torch.Generator().manual_seed(3 + r)
        h = torch.randn((2, S, 24), generator=g)
        w = torch.randn((24, 64), generator=g)
        with torch.no_grad():
            ra = row_parallel(h, w, q8, mesh.tp)
            rb = row_parallel(h, w, q8sp, mesh.tp, mesh.tp)
        q8_equal = (torch.equal(fa, fb) and torch.equal(local_slice(ra, 1, mesh.tp), rb)
                    and all(torch.equal(ca[i][k], cb[i][k])
                            for i in range(len(ca)) for k in ca[i]))
        q8_differ = worst(float(not q8_equal))[0]
        if r == 0:
            np.save(out + "/moe_kept.npy", kept.numpy())
            res["prefill"] = prefill
            res["q8_equal"] = q8_differ == 0.0
            json.dump(res, open(out + "/port.json", "w"))
        end_world()

    if __name__ == "__main__":
        from repro_torch.launch.mesh import free_port
        mp.spawn(rank, args=(free_port(),), nprocs=D * M)
""")

_JAX_SP = _COMMON + textwrap.dedent("""
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
        pol = make_run_policy(mesh, remat=True, sequence_parallel=True)
        step = jax.jit(make_train_step(cfg, pol, TrainerConfig(grad_accum=1, tp=M, **TC)))
        ms, arrays = [], {}
        for t, (toks, labels) in enumerate(batches(cfg), 1):
            batch = jax.device_put({"tokens": toks, "labels": labels},
                                   NamedSharding(mesh, P("data")))
            state, m = step(state, batch)
            ms.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
            arrays.update({f"{t}/{k}": v for k, v in flat(state["params"]).items()})
            arrays.update({f"{t}/v/{k}": v for k, v in flat(state["opt"]["v"]).items()})
        res[arch] = ms
        np.savez(f"{out}/jax_{arch}.npz", **arrays)
    json.dump(res, open(out + "/jax_sp.json", "w"))
""")

_JAX_OTHER = _COMMON + textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.sharding import make_run_policy, param_specs
    from repro.launch.steps import _named
    from repro.models.layers import RunPolicy
    from repro.models.transformer import set_policy_tp
    from repro.train import TrainerConfig, make_train_state, make_train_step
    from repro_torch.models import numpy_params
    from repro_torch.configs import get_config as port_config
    mesh = jax.make_mesh((D, M), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    res = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = jax.tree.map(jnp.asarray, numpy_params(port_config(arch).reduced(), 0, tp=M))
        for layout in ("single", "sharded"):
            if layout == "single":
                p, pol, place = params, set_policy_tp(RunPolicy(remat=True), M), jnp.asarray
            else:
                p = jax.device_put(params, _named(mesh, param_specs(params, mesh)))
                pol = make_run_policy(mesh, remat=True)
                place = lambda a: jax.device_put(a, NamedSharding(mesh, P("data")))
            step = jax.jit(make_train_step(cfg, pol, TrainerConfig(grad_accum=1, tp=M, **TC)))
            state, ms = make_train_state(cfg, p), []
            for toks, labels in batches(cfg):
                state, m = step(state, {"tokens": place(toks), "labels": place(labels)})
                ms.append([float(m["loss"]), float(m["grad_norm"])])
            res[f"{arch}/{layout}"] = ms
    json.dump(res, open(out + "/jax_other.json", "w"))
""")

# the three autograd pairs on 2 ranks, float64: each rank's gradient against
# one rank's autograd on the full tensors (saved by rank 0 as reference)
_PAIRS = textwrap.dedent("""
    import json, sys
    import torch
    import torch.multiprocessing as mp
    out = sys.argv[1]
    N, BB, SS, DD, FF = 2, 3, 8, 5, 6

    def rank(r, port):
        torch.set_num_threads(1)
        import torch.distributed as dist
        from repro_torch.launch.mesh import start_world, end_world
        from repro_torch.models.parallel import (Axis, gather_to, local_slice,
                                                 reduce_scatter_from, scatter_to)
        start_world(r, N, backend="gloo", port=port)
        ax = Axis(dist.group.WORLD, N, r)
        g = torch.Generator().manual_seed(0)
        X = torch.randn((BB, SS, DD), generator=g, dtype=torch.float64)
        W = torch.randn((DD, FF), generator=g, dtype=torch.float64)
        G = torch.randn((BB, SS, FF), generator=g, dtype=torch.float64)
        P = torch.randn((N, BB, SS, FF), generator=g, dtype=torch.float64)
        err = {}
        # gather_to: a column-parallel product of the gathered sequence
        Wr = local_slice(W, 1, ax)
        xl = local_slice(X, 1, ax).clone().requires_grad_(True)
        y = gather_to(xl, 1, ax) @ Wr
        (y * local_slice(G, 2, ax)).sum().backward()
        Xr = X.clone().requires_grad_(True)
        ((Xr @ W) * G).sum().backward()
        err["gather_to"] = [float((y - local_slice(X @ W, 2, ax)).abs().max()),
                            float((xl.grad - local_slice(Xr.grad, 1, ax)).abs().max())]
        # reduce_scatter_from: this rank's positions of the ranks' sum
        pr = P[r].clone().requires_grad_(True)
        z = reduce_scatter_from(pr, 1, ax)
        (z * local_slice(G, 1, ax)).sum().backward()
        Pr = P.clone().requires_grad_(True)
        (Pr.sum(0) * G).sum().backward()
        err["reduce_scatter_from"] = [
            float((z - local_slice(P.sum(0), 1, ax)).abs().max()),
            float((pr.grad - Pr.grad[r]).abs().max())]
        # scatter_to: a replicated tensor made seq-split
        yr = (X @ W).requires_grad_(True)
        z = scatter_to(yr, 1, ax)
        (z * local_slice(G, 1, ax)).sum().backward()
        Yr = (X @ W).requires_grad_(True)
        (Yr * G).sum().backward()
        err["scatter_to"] = [float((z - local_slice(X @ W, 1, ax)).abs().max()),
                             float((yr.grad - Yr.grad).abs().max())]
        if r == 0:
            json.dump(err, open(out + "/pairs.json", "w"))
        end_world()

    if __name__ == "__main__":
        from repro_torch.launch.mesh import free_port
        mp.spawn(rank, args=(free_port(),), nprocs=N)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("seqpar")
    np.save(out / "moe_x.npy", _moe_x())
    fill = dict(archs=ARCHS, d=D, m=M, b=B, s=S, steps=STEPS, tc=TC, cf=MOE_CF,
                prefill_s=PREFILL_S, other=OTHER)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for name, code in (("port_side", _PORT), ("jax_sp", _JAX_SP),
                       ("jax_other", _JAX_OTHER), ("pairs", _PAIRS)):
        (out / f"{name}.py").write_text(code % fill if "%(" in code else code)
        procs[name] = subprocess.Popen(
            [sys.executable, str(out / f"{name}.py"), str(out)], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, (name, err[-3000:])
    return out, json.loads((out / "port.json").read_text())


class _Arrays(dict):
    """An npz file's arrays as ``_assert_close`` reads them (``files``)."""

    @property
    def files(self):
        return list(self)


def _params(path):
    """The per-step params of a port run (its AdamW v left out)."""
    npz = np.load(path)
    return _Arrays({k: npz[k] for k in npz.files if "/v/" not in k})


@pytest.mark.parametrize("arch", ARCHS)
def test_seqpar_step_matches_jax_seqpar_step(runs, arch):
    """Loss and grad norm within RTOL of the JAX sharded step with
    ``sequence_parallel=True``, params as ``test_torch_launch._assert_close``
    holds them. The grad norm's bound adds the reference's own spread where
    it exceeds RTOL: the largest relative difference among its seqpar,
    sharded and single-device steps (rwkv6: about 3.4e-5 at step 1, the
    rounding of its wkv backward by layout)."""
    out, port = runs
    jax_ms = json.loads((out / "jax_sp.json").read_text())[arch]
    other = json.loads((out / "jax_other.json").read_text())
    norms = [[m[1] for m in jax_ms]] + [[m[1] for m in other[f"{arch}/{layout}"]]
                                        for layout in ("single", "sharded")]
    spread = [(max(g) - min(g)) / min(g) for g in zip(*norms)]
    _assert_close([m[:2] for m in port[f"{arch}/1"]], jax_ms,
                  _params(out / f"port_{arch}_1.npz"),
                  np.load(out / f"jax_{arch}.npz"), spread)


@pytest.mark.parametrize("arch", ARCHS + OTHER)
def test_seqpar_step_matches_the_unsplit_step(runs, arch):
    """The same world's step with and without sequence parallelism: losses
    and grad norms within RTOL, params within RTOL of max |param| (the
    AdamW bound where the unsplit run's update is ill-conditioned)."""
    out, port = runs
    name = arch.replace("/", "_")
    _assert_close([m[:2] for m in port[f"{arch}/1"]], port[f"{arch}/0"],
                  _params(out / f"port_{name}_1.npz"),
                  np.load(out / f"port_{name}_0.npz"))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", PREFILL_S)
def test_seqpar_prefill(runs, arch, s):
    """Last-position logits and every cache within RTOL of their max |value|
    of the unsplit prefill where the 4 model ranks divide S; bit-equal where
    they do not (the residual stays whole)."""
    _, port = runs
    p = port["prefill"][f"{arch}/{s}"]
    if s % M:
        assert p["differ"] == 0.0, p
    else:
        assert p["logit_err"] <= RTOL * p["logit_scale"], p
        assert p["cache_err"] <= RTOL * p["cache_scale"], p


@pytest.mark.parametrize("pair", ["gather_to", "reduce_scatter_from", "scatter_to"])
def test_autograd_pairs_match_one_rank(runs, pair):
    out, _ = runs
    fwd, grad = json.loads((out / "pairs.json").read_text())[pair]
    assert fwd <= 1e-12 and grad <= 1e-12, (fwd, grad)


def test_moe_drops_bit_equal_under_seqpar(runs):
    """The kept routings of the 2 x 4 world, each rank holding 4 of the 16
    positions of its data rank's rows, are those of one device, and some
    are dropped: the layer routes the gathered sequence."""
    out, _ = runs
    cfg = get_config("olmoe-1b-7b").reduced()
    model = load_jax_params(cfg, numpy_params(cfg, 0, tp=M), "cpu", tp=M)
    want = moe_kept(cfg, model.layers[0].ffn.params(), torch.from_numpy(_moe_x()),
                    RunPolicy(moe_capacity_factor=MOE_CF), tp=M)
    got = np.load(out / "moe_kept.npy")
    np.testing.assert_array_equal(got, want.numpy())
    assert not want.all() and want.any()


def test_q8_collectives_with_seqpar_give_the_local_positions(runs):
    """Under ``quantize_tp_collectives`` the row-parallel exit is the int8
    all-reduce then this rank's positions: the forward logits and prefill
    caches equal the q8 pass's without sequence parallelism, exactly."""
    _, port = runs
    assert port["q8_equal"]


def test_seq_axis_applies_only_where_it_splits():
    """Sequence parallelism needs the option, a model axis of more than one
    rank and a sequence it divides; otherwise the residual stays whole."""
    four, one = Axis(None, 4, 1), Axis(None, 1, 0)
    mesh = SimpleNamespace(tp=four, dp=one)
    assert seq_axis(RunPolicy(mesh=mesh, sequence_parallel=True), 16) is four
    assert seq_axis(RunPolicy(mesh=mesh, sequence_parallel=True), 18) is None
    assert seq_axis(RunPolicy(mesh=mesh, sequence_parallel=True), 1) is None
    assert seq_axis(RunPolicy(mesh=mesh), 16) is None
    assert seq_axis(RunPolicy(sequence_parallel=True), 16) is None
    assert seq_axis(RunPolicy(mesh=SimpleNamespace(tp=one, dp=one),
                              sequence_parallel=True), 16) is None


def test_make_run_policy_sets_sequence_parallel_on_a_mesh_only():
    from repro_torch.launch.sharding import make_run_policy

    assert not make_run_policy(None, sequence_parallel=True).sequence_parallel
    assert not RunPolicy().sequence_parallel
