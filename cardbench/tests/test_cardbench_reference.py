"""The plain reference against the port at a reduced size on the CPU:
whole-sequence logits of the dense GQA block and of the qk-norm MoE block,
the MoE layer's top-k routing and capacity drops, and the replay of a
served schedule against the engine's own tokens and states."""
import copy
import time

import pytest
import torch

from cardbench.lib import check, reference, serve, weights
from cardbench.tests import tiny


def _model(cfg_file, seed):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import TransformerLM
    arch = cfg_file["arch"]
    m = TransformerLM(ArchConfig(**arch), device="meta")
    m.load_state_dict(weights.make(arch, seed, "cpu"), assign=True)
    return m


@pytest.mark.parametrize("cell", ["yi6b-batch", "olmoe-batch"])
def test_sequence_logits_match_the_port(cell):
    torch.set_num_threads(1)
    cf = tiny.spec(cell)["cfg_file"]
    toks = torch.randint(2, 256, (1, 40), generator=torch.Generator().manual_seed(1))
    want = _model(cf, 5).forward(toks)[0]
    ref = reference.Reference(cf["arch"], weights.make(cf["arch"], 5, "cpu"))
    _, got = ref.sequence(toks[0].tolist(), slice(0, 40))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_moe_drops_as_the_port():
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.layers import RunPolicy
    from repro_torch.models.moe import moe_apply_dense, moe_kept
    torch.set_num_threads(1)
    arch = tiny.spec("olmoe-batch")["cfg_file"]["arch"]
    W = weights.make(arch, 3, "cpu")
    p = {k.split(".")[-1]: v for k, v in W.items() if k.startswith("layers.0.ffn.")}
    h = torch.randn(48, arch["d_model"], generator=torch.Generator().manual_seed(2))
    cfg, pol = ArchConfig(**arch), RunPolicy(moe_capacity_factor=1.25)
    kept = moe_kept(cfg, p, h[None], pol)
    assert not bool(kept.all())  # the capacity drops some routings
    want, _ = moe_apply_dense(cfg, p, h[None], pol)
    got = reference.moe(arch, W, "layers.0.", h, 1.25)
    assert torch.allclose(got, want[0], atol=1e-5, rtol=1e-5)
    assert not torch.allclose(reference.moe(arch, W, "layers.0.", h, 100.0),
                              want[0], atol=1e-3)


def _served(cell, seed=2 ** 31 + 3):
    torch.set_num_threads(1)
    s = tiny.spec(cell)
    model, eng = serve.build_engine(s["cfg_file"], weights.make(
        s["cfg_file"]["arch"], seed, "cpu"), "cpu")
    serve.warm_up(eng, s["cfg_file"], seed)
    sess = serve.Session(eng, s["traffic"], seed, s["cfg_file"]["arch"]["vocab_size"])
    sess.capture(model)
    sess._open(time.perf_counter(), 0.5, None)
    sess.run(0.5)
    served = {rid: list(r.generated) for rid, r in eng.requests.items()
              if rid in sess.reqs}
    return s, sess, served, seed


@pytest.mark.parametrize("cell", ["yi6b-batch", "olmoe-batch"])
def test_served_tokens_match_the_reference(cell):
    s, sess, served, seed = _served(cell)
    v = check.judge(s["cfg_file"], sess, served, seed, "cpu", s["limits"])
    r = v["readings"]
    assert v["judged_requests"] >= 8 and v["correct"], r
    assert r["served_logit_gap"] <= 1e-5 and r["final_hidden_err"] <= 1e-5


def test_replay_needs_the_drops():
    """With the capacity lifted in the reference alone, the replay no longer
    matches the engine's MoE states: the drops are what it follows."""
    s, sess, served, seed = _served("olmoe-batch")
    cf = copy.deepcopy(s["cfg_file"])
    cf["policy"]["moe_capacity_factor"] = 100.0
    r = check.judge(cf, sess, served, seed, "cpu", s["limits"])["readings"]
    assert r["final_hidden_err"] > 1e-3


def test_captured_states_span_many_buffers(monkeypatch):
    """States written across many small host buffers (made as they fill)
    are found again for every judged token."""
    monkeypatch.setattr(serve, "CAPTURE_ROWS", 16)
    monkeypatch.setattr(serve, "CAPTURE_BUFFERS", 1)
    s, sess, served, seed = _served("yi6b-batch")
    assert len(sess._bufs) > 4
    v = check.judge(s["cfg_file"], sess, served, seed, "cpu", s["limits"])
    r = v["readings"]
    assert v["correct"] and r["state_uncaptured"] == 0, r
    assert r["final_hidden_err"] <= 1e-5
