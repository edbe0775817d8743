"""The port's examples (python -m repro_torch.examples.<name>) on the CPU:
each main exits cleanly and prints the modeled charge numbers of the JAX
example of the same name (examples/<name>.py); the training examples print
the JAX example's config lines and a finite, improving loss."""
import dataclasses
import math
import runpy
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.core import GRACE_HOPPER as JAX_GRACE_HOPPER
from repro_torch.examples import (
    buffer_api,
    qv_oversubscription,
    quickstart,
    serve_batched,
    trace_replay,
    train_100m,
)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_main(name: str, **globals_):
    """The JAX example's main, with module globals replaced."""
    main = runpy.run_path(str(EXAMPLES / f"{name}.py"),
                          run_name=f"jax_example_{name}")["main"]
    main.__globals__.update(globals_)
    return main


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_trace_replay(tmp_path, capsys):
    assert _jax_main("trace_replay")(
        ["--trace", str(tmp_path / "t.trace.gz"), "--policy", "mi300a_unified",
         "managed"]) == 0
    want = _lines(capsys)
    assert trace_replay.main(
        ["--trace", str(tmp_path / "t.trace.gz"), "--policy", "mi300a_unified",
         "managed", "--device", "cpu"]) == 0
    got = _lines(capsys)
    assert got == want and len(got) == 4
    assert all(line.startswith("OK ") for line in got[1:])


def test_buffer_api(capsys):
    _jax_main("buffer_api")()
    want = _lines(capsys)
    buffer_api.main(["--device", "cpu"])
    got = _lines(capsys)
    # the port also sums the rows it streams: 2 * sum_r (256 r + c) at c = 0
    acc = [line for line in got if line.startswith("acc[:2]")]
    assert acc == ["acc[:2] = [2146959360.0, 2146963456.0] on cpu"]
    assert [line for line in got if line not in acc] == want


def test_qv_oversubscription(capsys):
    _jax_main("qv_oversubscription")(12)
    want = _lines(capsys)
    qv_oversubscription.main(["12", "--device", "cpu"])
    assert _lines(capsys) == want


def test_serve_batched(capsys):
    """The JAX example models a TPU v5e; run under GRACE_HOPPER, as the
    port's example is, its scheduler and umem numbers are the port's. The
    weights (and so the tokens) come from each package's own generator."""
    _jax_main("serve_batched", TPU_V5E=JAX_GRACE_HOPPER)()
    want = _lines(capsys)
    serve_batched.main(["--device", "cpu"])
    got = _lines(capsys)

    def charges(lines):
        return ([ln for ln in lines if ln.startswith(("request ", "scheduler:"))]
                + [ln.split(": ", 1)[1] for ln in lines
                   if ln.startswith("umem (modeled")])

    assert len(charges(got)) == 8 and charges(got) == charges(want)
    assert sum(ln.startswith("  req ") for ln in got) == 6


@pytest.mark.parametrize("arch", ["yi-6b", "musicgen-medium"])
def test_quickstart(arch, capsys):
    """One forward, a train step of two microbatches and three decode steps;
    the config lines are the JAX example's."""
    quickstart.main([arch, "--device", "cpu"])
    got = _lines(capsys)
    cfg = jax_get_config(arch).reduced()
    assert got[:3] == [f"archs available: {jax_list_archs()}", "",
                       f"== {arch} (reduced: {cfg.num_layers}L d={cfg.d_model}) =="]
    assert got[3].startswith(f"forward: (2, 32, {cfg.vocab_size}) -> ")
    loss, gnorm = (float(f.split("=")[1]) for f in got[4].split()[2:4])
    assert got[4].startswith("train step: ") and math.isfinite(loss) and gnorm > 0
    assert [ln.split(":")[0] for ln in got[5:]] == [
        f"decode step {i}" for i in range(3)]


def test_train_100m(capsys, tmp_path):
    """A few steps of the ~100M-param model: the JAX example's parameter
    count, and a loss that improves (the example asserts it)."""
    out = train_100m.main(["--steps", "6", "--seq", "32", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)])
    got = _lines(capsys)
    cfg = dataclasses.replace(
        jax_get_config("yi-6b"), name="yi-100m", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=8192)
    assert got[0] == f"params: {cfg.param_count()/1e6:.1f}M"
    assert got[1].startswith("steps=6 restarts=0 loss ")
    assert out["restarts"] == 0 and len(out["history"]) == 6
    assert all(math.isfinite(h["loss"]) for h in out["history"])
