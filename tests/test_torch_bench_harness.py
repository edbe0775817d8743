"""The port's benchmark harness, ``python -m repro_torch.bench.run``:
``kernels_micro`` prints the JAX module's rows and derived strings, and the
runner's modules, flags and exit codes."""
import contextlib
import importlib
import io
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (each port test file runs beside JAX)
import pytest
import torch

from repro_torch.bench import run as bench_run
from repro_torch.kernels.flash_attention import flash_attention

ROOT = Path(__file__).resolve().parent.parent
# the JAX package's benchmarks/ lives at the root of the checkout
sys.path.append(str(ROOT))


def _csv(module: str, **kw) -> str:
    """What ``module.run(**kw)`` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(module).run(**kw)
    return buf.getvalue()


def _main(argv):
    """``bench_run.main(argv)``: its exit code and what it printed."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_run.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_kernels_micro_rows_match_jax():
    """Same rows, order and derived strings; the times are each device's
    own (the plain versions on the CPU here)."""
    before = flash_attention.launches
    got = [ln.split(",") for ln in
           _csv("repro_torch.bench.kernels_micro", device="cpu").splitlines()]
    want = [ln.split(",") for ln in
            _csv("benchmarks.kernels_micro").splitlines()]
    assert [(r[0], r[2]) for r in got] == [(r[0], r[2]) for r in want]
    assert [r[0] for r in got] == [
        "kernel/flash_attention_256", "kernel/paged_attention",
        "kernel/qv_gate_14q", "kernel/stencil5_512x256"]
    assert all(float(r[1]) > 0 for r in got)
    assert flash_attention.launches == before  # plain versions only


def test_modules_are_the_eight_figure_and_kernel_modules():
    # the eight, then the serving, roofline and training benchmarks, in the
    # order of benchmarks/run.py (sim_throughput runs only the charge model
    # and is not ported)
    assert [m.rsplit(".", 1)[1] for m in bench_run.MODULES] == [
        "fig3_overview", "fig45_timeline", "fig67_pagesize", "fig89_qiskit",
        "fig10_srad_migration", "fig11_oversub", "fig1213_prefetch",
        "kernels_micro", "lm_serve_paged", "lm_roofline", "train_oversub"]
    for m in bench_run.MODULES:
        assert "device" in importlib.import_module(m).run.__code__.co_varnames


def test_run_as_module_on_cpu_exits_0():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--device", "cpu",
         "repro_torch.bench.fig10_srad_migration"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ("name,us_per_call,derived\n"
                           + _csv("benchmarks.fig10_srad_migration"))


def test_jobs_give_the_same_csv():
    rc, serial, _ = _main(["--device", "cpu",
                           "repro_torch.bench.fig45_timeline",
                           "repro_torch.bench.fig1213_prefetch"])
    assert rc == 0
    rc, fanned, _ = _main(["--device", "cpu", "--jobs", "2",
                           "repro_torch.bench.fig45_timeline",
                           "repro_torch.bench.fig1213_prefetch"])
    assert rc == 0
    assert fanned == serial
    assert len(serial.splitlines()) == 1 + 4 + 6


def test_policy_override_skips_modules_without_it():
    rc, out, err = _main(["--device", "cpu", "--policy", "managed",
                          "repro_torch.bench.fig3_overview",
                          "repro_torch.bench.fig10_srad_migration"])
    assert rc == 0
    assert "# repro_torch.bench.fig10_srad_migration: skipped" in err
    assert [ln.split(",")[0] for ln in out.splitlines()[1:]] == [
        f"fig3/{app}/managed" for app in ("qiskit", "needle", "pathfinder",
                                          "bfs", "hotspot", "srad")]


def test_failing_module_exits_nonzero():
    rc, _, err = _main(["--device", "cpu", "repro_torch.bench.no_such_module"])
    assert rc == 1
    assert "benchmark failures: ['repro_torch.bench.no_such_module']" in err


def test_default_device_is_the_card(monkeypatch):
    """Without --device the modules run on the card, and with none they
    fail: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _, err = _main(["repro_torch.bench.kernels_micro",
                        "repro_torch.bench.fig10_srad_migration"])
    assert rc == 1
    assert err.count("no CUDA device") == 2


@pytest.mark.parametrize("argv", [["--jobs", "x"], ["--device"],
                                  ["--bogus"]])
def test_bad_flags_exit_2(argv):
    with pytest.raises(SystemExit) as e:
        _main(argv)
    assert e.value.code == 2
