"""A whole run on the CPU (past the harness's look for a card), with the
timed path broken underneath: ``correct`` has to come out false. Faults a
serving cell can have: a token altered where it is produced; a decode step
that leaves its state unchanged (the new token's K and V never written);
for the MoE cell, experts' capacity changed in the program alone. A sound
run of the same size comes out true."""
import pytest
import torch

from cardbench.tests import tiny

CELLS = ["yi6b-chat", "olmoe-batch"]


def _altered_token(model, eng):
    real = model.logits_out
    calls = [0]

    def logits_out(x, *a, **kw):
        lg = real(x, *a, **kw)
        calls[0] += 1
        if calls[0] % 7 == 0:  # now and then, the second best wins
            top2 = torch.topk(lg, 2, dim=-1).indices[..., 1:]
            lg = lg.scatter(-1, top2, float(lg.max()) + 1.0)
        return lg
    model.logits_out = logits_out


def _state_unchanged(model, eng):
    eng.cache.write_token = lambda *a, **kw: None


def _capacity(model, eng):
    eng.policy.moe_capacity_factor = 0.5


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = tiny.run(tiny.spec(cell))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged])
def test_fault_is_not_correct(cell, fault):
    out = tiny.run(tiny.spec(cell), prepare=fault)
    assert not out["correct"], out["checks"]


def test_moe_capacity_fault_is_not_correct():
    out = tiny.run(tiny.spec("olmoe-batch"), prepare=_capacity)
    assert not out["correct"], out["checks"]


class _NoHandle:
    def remove(self):
        pass


def _norm_unhooked(model, eng):
    """The final norm runs without the module call a hook sees, as it would
    folded into the head or replayed from a CUDA graph."""
    model.final_norm.register_forward_hook = lambda fn: _NoHandle()


def test_uncaptured_state_is_named_and_not_correct():
    out = tiny.run(tiny.spec("yi6b-batch"), prepare=_norm_unhooked)
    assert not out["correct"]
    assert out["checks"]["state_uncaptured"]["value"] > 0
    assert out["checks"]["counter_mismatch"]["value"] == 0
    assert out["checks"]["served_logit_gap"]["value"] <= 1e-5
