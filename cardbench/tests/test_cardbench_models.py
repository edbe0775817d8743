"""A configuration's model module (``cardbench/lib/model.py``): the two
configurations go through ``models/decoder.py`` and draw, serve, judge and
count as the functions of ``weights``, ``reference`` and ``counts`` do; a
configuration with a block the default layout cannot load (a bias on q, k
and v) comes as new files only and is judged correct, and wrong where its
biases are dropped; a model module that imports the program is refused."""
import copy
import json
import math
from itertools import islice
from pathlib import Path

import pytest
import torch

from cardbench.lib import check, counts, model, serve, weights
from cardbench.lib.traffic import RequestStream
from cardbench.tests import tiny

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
CELLS = ["yi6b-chat", "olmoe-batch", "yi6b-batch", "yi6b-docqa"]
DECODER = "cardbench/models/decoder.py"
QKV_BIAS = "cardbench/tests/qkv_bias_model.py"


def _cfg_file(name, size):
    if size == "full":
        return json.loads((CONFIGS / f"{name}.json").read_text())
    cell = {"yi-6b": "yi6b-batch", "olmoe-1b-7b": "olmoe-batch"}[name]
    return tiny.spec(cell)["cfg_file"]


@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("name", ["yi-6b", "olmoe-1b-7b"])
def test_layout_and_counts_unchanged(name, size):
    cf = _cfg_file(name, size)
    assert "model" not in cf
    m, arch = model.load(cf), cf["arch"]
    assert m.layout(arch) == weights.layout(arch)
    assert sum(math.prod(s) for _, s, _ in m.layout(arch)) == \
        weights.param_count(arch)
    for p in (0, 1, 255, 4095):
        assert m.token_flops(arch, p) == counts.token_flops(arch, p)
    for a, b in ((0, 256), (256, 512), (3000, 3017)):
        assert m.span_flops(arch, a, b) == counts.span_flops(arch, a, b)
    assert m.head_flops(arch) == counts.head_flops(arch)
    lens = [1, 17, 300, 4096]
    assert m.paged_bytes(arch, lens) == \
        arch["num_layers"] * counts.paged_attention_bytes(arch, lens)


@pytest.mark.parametrize("name", ["yi-6b", "olmoe-1b-7b"])
def test_weights_bitwise_unchanged(name):
    cf = _cfg_file(name, "tiny")
    new = model.make_weights(cf, 2 ** 31 + 5, "cpu")
    old = weights.make(cf["arch"], 2 ** 31 + 5, "cpu")
    assert list(new) == list(old)
    assert all(torch.equal(new[k], old[k]) for k in old)


def _serve_all(cf, sd, traffic, seed, n=12):
    """Tokens served to the first ``n`` requests of the mix, all added at
    once and stepped to the end: a schedule that no clock moves."""
    model_, eng = serve.build_engine(cf, sd, "cpu")
    rids = [eng.add_request(r.prompt, r.max_new) for r in islice(
        RequestStream(traffic, seed, cf["arch"]["vocab_size"]), n)]
    while eng.step():
        pass
    return [list(eng.requests[r].generated) for r in rids]


@pytest.mark.parametrize("cell", CELLS)
def test_served_tokens_and_readings_unchanged(cell, monkeypatch):
    """The engine loaded through the model module serves the tokens it
    served from ``weights.make``; a run's readings are the same whether its
    configuration names the default module or not."""
    torch.set_num_threads(1)
    s, seed = tiny.spec(cell), 2 ** 31 + 21
    cf = s["cfg_file"]
    assert _serve_all(cf, model.make_weights(cf, seed, "cpu"), s["traffic"],
                      seed) == _serve_all(cf, weights.make(cf["arch"], seed,
                                                           "cpu"),
                                          s["traffic"], seed)
    seen, real = {}, check.judge

    def judge(cfg_file, sess, served, *a, **kw):
        seen.update(sess=sess, served=served, args=a)
        return real(cfg_file, sess, served, *a, **kw)
    monkeypatch.setattr(check, "judge", judge)
    out = tiny.run(s, seed=seed, readings=True)
    named = dict(cf, model=DECODER)
    again = real(named, seen["sess"], seen["served"], *seen["args"])
    assert out["correct"] and again["correct"]
    assert again["readings"] == out["readings"]
    assert again["checks"] == out["checks"]


def _qkv_bias_spec():
    s = tiny.spec("yi6b-batch")
    cf = copy.deepcopy(s["cfg_file"])
    cf["arch"].update(qkv_bias=True, name="yi-6b-qkv-bias")
    cf["model"] = QKV_BIAS
    return dict(s, cfg_file=cf)


def test_default_layout_cannot_load_a_qkv_bias_block():
    cf = _qkv_bias_spec()["cfg_file"]
    plain = {k: v for k, v in cf.items() if k != "model"}
    with pytest.raises(RuntimeError, match="bq"):
        serve.build_engine(plain, model.make_weights(plain, 3, "cpu"), "cpu")


def test_new_configuration_as_new_files_is_correct():
    out = tiny.run(_qkv_bias_spec())
    assert out["correct"], out["checks"]
    assert out["checks"]["final_hidden_err"]["value"] <= 1e-5


def _drop_biases(model_, eng):
    for blk in model_.layers:
        for b in (blk.mixer.bq, blk.mixer.bk, blk.mixer.bv):
            b.data.zero_()


def test_new_configuration_biases_dropped_is_not_correct():
    out = tiny.run(_qkv_bias_spec(), prepare=_drop_biases)
    assert not out["correct"], out["checks"]
    assert out["checks"]["final_hidden_err"]["value"] > 1e-2


@pytest.mark.parametrize("line", [
    "import repro_torch",
    "from repro_torch.models import attention",
    "import jax.numpy as jnp",
    "from repro.serve import engine",
    "import importlib\nm = importlib.import_module('repro_torch')",
])
def test_model_module_importing_the_program_is_refused(tmp_path, line):
    f = tmp_path / "bad_model.py"
    f.write_text(Path(model.ROOT / DECODER).read_text() + "\n" + line + "\n")
    with pytest.raises(ImportError, match="refused"):
        model.load({"arch": {}, "model": str(f)})


def test_model_module_lacking_a_count_is_refused(tmp_path):
    f = tmp_path / "partial_model.py"
    f.write_text(Path(model.ROOT / DECODER).read_text().replace(
        "def paged_bytes(", "def paged_bytes_of("))
    with pytest.raises(ImportError, match="paged_bytes"):
        model.load({"arch": {}, "model": str(f)})
