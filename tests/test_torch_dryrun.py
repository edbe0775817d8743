"""The port's dry-run (repro_torch.launch.{steps,analysis,dryrun,roofline})
on fake ranks, against the JAX package's analysis where they share a
function: one full-width cell of each kind on (16, 16) (depth cut to two
layers), the traced per-device FLOPs of a reduced cell against the analytic
count of its products, the wire-byte model against ``parse_collectives``,
and ``cell_terms`` / ``fmt_table`` against the JAX functions with the
constants set equal. The fake worlds start in a subprocess."""
import copy
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax  # noqa: F401  (each port test file runs beside JAX)
import pytest

from repro.launch import analysis as jax_analysis
from repro.launch import roofline as jax_roofline
from repro_torch.configs import get_config
from repro_torch.launch import analysis, roofline
from repro_torch.models.transformer import init_params_specs
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parent.parent
CELLS = [("yi-6b", "train_4k"), ("yi-6b", "prefill_32k"),
         ("yi-6b", "decode_32k"), ("rwkv6-1.6b", "long_500k")]
SEQPAR = [("yi-6b", "train_4k"), ("olmoe-1b-7b", "prefill_32k"),
          ("yi-6b", "decode_32k")]
REC_KEYS = {"arch", "shape", "mesh", "tag", "chips", "meta",
            "model_flops_global", "params", "active_params", "artifacts"}
ART_KEYS = {"lower_s", "compile_s", "memory", "cost", "collectives"}
MEM_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes", "peak_bytes_est"}

_WORLD = textwrap.dedent("""
    import json, sys
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import SHAPES, RunShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.analysis import CollectiveBytes
    from repro_torch.launch.mesh import end_world, make_host_mesh, start_fake_world
    from repro_torch.launch.steps import make_artifacts
    from repro_torch.models.parallel import all_gather, all_reduce_
    out = sys.argv[1]
    res = {}

    # a reduced prefill cell on a (2, 4) mesh of fake ranks: traced FLOPs
    start_fake_world(8, rank=5)
    mesh = make_host_mesh(2, 4)
    cfg = get_config("yi-6b").reduced()
    shape = RunShape("p", "prefill", 64, 4)
    with FakeTensorMode():
        arts = make_artifacts(cfg, shape, mesh, attn_block=4096)
        with FlopCounterMode(display=False) as fc:
            arts["prefill"]()
        res["reduced_prefill_flops"] = fc.get_total_flops()
        # the collectives CommDebugMode sees, with their bytes
        with CollectiveBytes() as cb:
            t = torch.empty(16, 64)
            all_reduce_(t, mesh.tp)
            all_gather(t, 0, mesh.dp)
        res["collectives"] = cb.summary()
        res["comm_counts"] = {str(k): v for k, v in cb.get_comm_counts().items()}
    end_world()

    for arch, shape_name in %(cells)r:
        dryrun.run_cell(arch, shape_name, multi_pod=False, out_dir=out,
                        layers=2, verbose=False)
    dryrun.run_cell("rwkv6-1.6b", "decode_32k", multi_pod=True, out_dir=out,
                    layers=2, verbose=False)
    dryrun.run_cell("yi-6b", "long_500k", multi_pod=False, out_dir=out,
                    verbose=False)
    # sequence parallelism beside the same cells without it
    for arch, shape_name in %(seqpar)r:
        for seqpar, tag in ((False, "unsplit"), (True, "seqpar")):
            dryrun.run_cell(arch, shape_name, multi_pod=False, out_dir=out,
                            layers=2, seqpar=seqpar, tag=tag, verbose=False)
    res["cli_rc"] = dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k",
                                 "--layers", "2", "--seqpar", "--tag", "seqpar_cli",
                                 "--out", out])
    end_world()
    json.dump(res, open(out + "/world.json", "w"))
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    (out / "world.py").write_text(_WORLD % {"cells": CELLS, "seqpar": SEQPAR})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(out / "world.py"), str(out)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out, json.loads((out / "world.json").read_text())


@pytest.mark.parametrize("arch,shape", CELLS)
def test_full_width_cell_records(world, arch, shape):
    out, _ = world
    rec = json.loads((out / "baseline" / f"{arch}__{shape}__16x16.json").read_text())
    assert set(rec) == REC_KEYS
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["meta"]["layers"] == 2
    names = {"train_4k": {"micro_grads", "opt_update", "train_memory"},
             "prefill_32k": {"prefill", "prefill_memory"},
             "decode_32k": {"decode", "decode_memory"},
             "long_500k": {"decode", "decode_memory"}}[shape]
    assert set(rec["artifacts"]) == names
    for name, art in rec["artifacts"].items():
        assert set(art) == ART_KEYS, name
        assert set(art["memory"]) == MEM_KEYS
        assert {"flops", "bytes_accessed", "transcendentals"} <= set(art["cost"])
        assert set(art["collectives"]) == {"by_op", "wire_bytes"}
        assert art["memory"]["peak_bytes_est"] > art["memory"]["argument_size_in_bytes"] > 0
    if shape == "train_4k":
        assert rec["meta"]["accum"] == 16 and rec["meta"]["micro"] == 16
        mg = rec["artifacts"]["micro_grads"]
        assert mg["cost"]["flops"] > 0 and mg["collectives"]["wire_bytes"] > 0
        assert set(mg["collectives"]["by_op"]) >= {"all-reduce"}
        # the data-parallel reduction of every grad is in the step's one
        # opt_update, not in each of the accum microbatches
        n_leaves = len(leaves(init_params_specs(
            dataclasses.replace(get_config(arch), num_layers=2), tp=16)))
        ou = rec["artifacts"]["opt_update"]["collectives"]["by_op"]
        assert ou["all-reduce"]["count"] >= n_leaves
        assert mg["collectives"]["by_op"]["all-reduce"]["count"] < n_leaves
    t = roofline.cell_terms(rec)
    assert t["dominant"] in ("compute", "memory", "collective")
    assert 0 < t["roofline_fraction"] <= 1.0


def _record(out, tag, arch, shape):
    return json.loads((out / tag / f"{arch}__{shape}__16x16.json").read_text())


@pytest.mark.parametrize("arch,shape,art", [("yi-6b", "train_4k", "micro_grads"),
                                            ("olmoe-1b-7b", "prefill_32k", "prefill")])
def test_seqpar_records_against_the_baseline(world, arch, shape, art):
    """Under ``--seqpar`` the blocks reduce-scatter and all-gather on the
    sequence; the FLOPs stay within 1 % of the baseline's and the peak
    memory is no higher (lower for the train cell: the remat'd blocks keep
    1/16 of their inputs). The ring model prices an all-reduce as an
    all-gather plus a reduce-scatter of its shard, so the train cell's wire
    bytes are the baseline's but for the remat recompute, which gathers
    each block's seq-split input once more (the baseline's recompute reads
    its saved whole input): L all-gathers of a (rows, S, d) bf16 tensor."""
    out, _ = world
    base, sp = _record(out, "unsplit", arch, shape), _record(out, "seqpar", arch, shape)
    assert sp["meta"]["sequence_parallel"] and "sequence_parallel" not in base["meta"]
    a, b = base["artifacts"][art], sp["artifacts"][art]
    by_op = b["collectives"]["by_op"]
    assert by_op["reduce-scatter"]["count"] > 0 and by_op["all-gather"]["count"] > 0
    assert b["cost"]["flops"] == pytest.approx(a["cost"]["flops"], rel=0.01)
    peak_b, peak_a = (r["artifacts"][art]["memory"]["peak_bytes_est"]
                      for r in (sp, base))
    assert peak_b <= peak_a
    if shape == "train_4k":
        assert peak_b < peak_a
        cfg = get_config(arch)
        rows = sp["meta"]["micro"] // 16
        regather = 2 * analysis.wire_bytes("all-gather", 16,
                                           rows * 4096 * cfg.d_model * 2)
        assert b["collectives"]["wire_bytes"] == pytest.approx(
            a["collectives"]["wire_bytes"] + regather, rel=0.02)


def test_seqpar_leaves_decode_unchanged(world):
    """At one token per sequence nothing splits: the decode record under
    --seqpar equals the one without it but for its trace seconds and tag."""
    out, res = world
    base = _record(out, "unsplit", "yi-6b", "decode_32k")
    for tag in ("seqpar", "seqpar_cli"):
        sp = _record(out, tag, "yi-6b", "decode_32k")
        assert sp["tag"] == tag and sp["meta"] == dict(base["meta"],
                                                        sequence_parallel=True)
        for name, art in base["artifacts"].items():
            for key in ("cost", "collectives", "memory"):
                assert sp["artifacts"][name][key] == art[key], (tag, name, key)
    assert res["cli_rc"] == 0


def test_skipped_and_multi_pod_records(world):
    out, _ = world
    rec = json.loads((out / "baseline" / "yi-6b__long_500k__16x16.json").read_text())
    assert rec == {"arch": "yi-6b", "shape": "long_500k", "mesh": "16x16",
                   "skipped": "full-attention arch at 500k ctx"}
    rec = json.loads((out / "baseline" / "rwkv6-1.6b__decode_32k__2x16x16.json")
                     .read_text())
    assert rec["chips"] == 512 and rec["mesh"] == "2x16x16"
    rows = roofline.load(str(out), "baseline")
    assert len(rows) == 6 and sum("skipped" in r for r in rows) == 1


def test_reduced_cell_flops_match_the_analytic_count(world):
    """One rank of (2, 4): 2 of 4 rows, 1 of 4 q heads and kv heads (the
    layout at tp 4: 2 kv heads replicated to 4), 32 of 128 d_ff columns,
    64 of 256 vocab rows; unblocked attention computes the full S x S."""
    _, res = world
    Bl, S, d, hd, f, V, L = 2, 64, 64, 16, 128 // 4, 256 // 4, 2
    nq = nkv = 1
    T = Bl * S
    per_layer = (2 * T * d * (nq + 2 * nkv) * hd     # q, k, v
                 + 2 * 2 * Bl * S * S * nq * hd      # q k^T and p v
                 + 2 * T * nq * hd * d               # o
                 + 3 * 2 * T * d * f)                # gate, up, down
    want = L * per_layer + 2 * Bl * d * V           # last position's logits
    got = res["reduced_prefill_flops"]
    assert abs(got - want) <= 0.02 * want, (got, want)


def test_collectives_seen_by_comm_debug_mode(world):
    _, res = world
    assert sum(res["comm_counts"].values()) == 2
    c = res["collectives"]
    nbytes = 16 * 64 * 4
    assert c["by_op"]["all-reduce"]["wire_bytes"] == pytest.approx(2 * 3 / 4 * nbytes)
    assert c["by_op"]["all-gather"]["tensor_bytes"] == 2 * nbytes
    assert c["wire_bytes"] == pytest.approx(2 * 3 / 4 * nbytes + 1 / 2 * 2 * nbytes)


@pytest.mark.parametrize("line,op,n", [
    ("%ar = f32[16,64]{1,0} all-reduce(f32[16,64]{1,0} %x), "
     "replica_groups=[16,16]<=[256], to_apply=%add", "all-reduce", 16),
    ("%ag = bf16[32,128]{1,0} all-gather-start(bf16[2,128]{1,0} %x), "
     "replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}", "all-gather", 4),
    ("%rs = f32[8,8]{1,0} reduce-scatter(f32[64,8]{1,0} %x), "
     "replica_groups=[32,8]<=[256], dimensions={0}", "reduce-scatter", 8),
    ("%a2a = s8[4,16]{1,0} all-to-all(s8[4,16]{1,0} %x), "
     "replica_groups={{0,1}}, dimensions={0}", "all-to-all", 2),
    ("%cp = f32[128]{0} collective-permute(f32[128]{0} %x), "
     "source_target_pairs={{0,1},{1,0}}", "collective-permute", 2),
])
def test_wire_bytes_match_parse_collectives(line, op, n):
    want = jax_analysis.parse_collectives(line)
    d = want["by_op"][op]
    assert analysis.wire_bytes(op, n, d["tensor_bytes"]) == pytest.approx(
        want["wire_bytes"], rel=1e-12)


def _records():
    """Synthetic records of each kind, and a skipped one."""
    def art(f, b, w, peak):
        return {"cost": {"flops": f, "bytes_accessed": b, "transcendentals": 0.0},
                "collectives": {"by_op": {}, "wire_bytes": w},
                "memory": {"peak_bytes_est": peak}}

    base = {"mesh": "16x16", "chips": 256, "tag": "t"}
    return [
        dict(base, arch="a", shape="train_4k", meta={"accum": 16, "micro": 16},
             model_flops_global=6e18,
             artifacts={"micro_grads": art(1.5e15, 4e12, 3e10, 5e10),
                        "opt_update": art(2e9, 7e10, 4e9, 6e10),
                        "train_memory": art(0, 0, 0, 7e10)}),
        dict(base, arch="a", shape="prefill_32k", meta={}, model_flops_global=3e17,
             artifacts={"prefill": art(9e14, 6e12, 3e10, 8e9),
                        "prefill_memory": art(0, 0, 0, 9e9)}),
        dict(base, arch="b", shape="decode_32k", meta={}, model_flops_global=2e13,
             artifacts={"decode": art(1e11, 4e11, 1e12, 9e10),
                        "decode_memory": art(0, 0, 0, 9.5e10)}),
        {"arch": "c", "shape": "long_500k", "mesh": "16x16",
         "skipped": "full-attention arch at 500k ctx"},
    ]


def test_cell_terms_and_table_match_jax(monkeypatch):
    monkeypatch.setattr(jax_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jax_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jax_roofline, "ICI_BW", roofline.LINK_BW)
    monkeypatch.setattr(jax_roofline, "HBM_PER_CHIP", roofline.HBM_PER_CHIP)
    rows, jrows = [], []
    for rec in _records():
        got = roofline.cell_terms(copy.deepcopy(rec))
        want = jax_roofline.cell_terms(copy.deepcopy(rec))
        assert got == want
        if got is None:
            rows.append({k: rec[k] for k in ("arch", "shape", "mesh", "skipped")})
            jrows.append(rows[-1])
        else:
            rows.append(got)
            jrows.append(want)
    assert roofline.fmt_table(rows) == jax_roofline.fmt_table(jrows)
    doms = {r.get("dominant") for r in rows}
    assert {"compute", "memory", "collective"} <= doms


def test_h100_constants_registered():
    from repro_torch.core.registry import get_hardware

    hw = get_hardware("h100-sxm")
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 50e9)
    assert hw.device_bw == 3.35e12 and hw.device_capacity == 80 * 10**9


def test_lm_roofline_rows(world, monkeypatch, capsys):
    """The port's lm_roofline module prints the reference's row names over
    the port's records."""
    out, _ = world
    from repro_torch.bench import lm_roofline

    monkeypatch.setenv("DRYRUN_DIR", str(out))
    lm_roofline.run(device="cpu")
    names = [ln.split(",")[0] for ln in capsys.readouterr().out.splitlines()]
    assert "roofline/yi-6b/train_4k/16x16" in names
    assert "roofline/rwkv6-1.6b/decode_32k/2x16x16" in names
    assert len(names) == 6
    monkeypatch.setenv("DRYRUN_DIR", str(out / "none"))
    lm_roofline.run(device="cpu")
    assert capsys.readouterr().out.startswith("lm_roofline/missing,0.000,")
