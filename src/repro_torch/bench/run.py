"""Benchmark harness of the port: one module per paper figure plus
``kernels_micro``, ``lm_serve_paged`` and ``train_oversub``. CSV to stdout.

    python -m repro_torch.bench.run [--device cpu] [--jobs N]
        [--policy NAME] [--hw NAME] [--json [DIR]] [modules]

Exits non-zero if ANY module fails. With no module named
(``repro_torch.bench.fig3_overview``, ...), all of ``MODULES`` run;
``repro_torch.bench.fault_serve`` and ``repro_torch.bench.cluster_scaling``
run by name.

Modules that write a ``BENCH_<module>.json`` snapshot write it to
``build/bench_json/`` (``repro_torch.bench.common.json_dir``);
``--json DIR`` sends it to DIR instead (a bare ``--json`` keeps the
default, so the committed snapshots at the repo root are never touched).

``--device`` is where the apps and kernels run: the CUDA card by default,
``cpu`` for the plain versions (the figure modules' numbers are modeled
charges, equal on both). ``--jobs N`` fans the modules out over N worker
processes (spawn), each with its stdout/stderr captured; the parent prints
them in submission order, so the CSV stays deterministic, and a crashed
worker fails the run. ``--policy``/``--hw`` run the figure suites under a
registered memory-policy backend / hardware model; modules whose ``run()``
takes no such override are skipped with a note on stderr.
"""
import contextlib
import importlib
import inspect
import io
import multiprocessing
import os
import sys
import traceback
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool

from repro_torch.bench.common import header

MODULES = [
    "repro_torch.bench.fig3_overview",
    "repro_torch.bench.fig45_timeline",
    "repro_torch.bench.fig67_pagesize",
    "repro_torch.bench.fig89_qiskit",
    "repro_torch.bench.fig10_srad_migration",
    "repro_torch.bench.fig11_oversub",
    "repro_torch.bench.fig1213_prefetch",
    "repro_torch.bench.kernels_micro",
    "repro_torch.bench.lm_serve_paged",
    "repro_torch.bench.train_oversub",
]


def _usage(msg: str):
    print(f"repro_torch.bench.run: {msg}", file=sys.stderr)
    raise SystemExit(2)


def _pop_value_flag(argv: list, flag: str):
    """Remove ``flag VALUE`` from argv and return VALUE (or None)."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    argv.pop(i)
    if i >= len(argv) or argv[i].startswith("-"):
        _usage(f"{flag} needs a value")
    return argv.pop(i)


def _takes_overrides(m: str, overrides: dict) -> bool:
    """Whether module m's run() accepts every override kwarg."""
    params = inspect.signature(importlib.import_module(m).run).parameters
    return all(k in params for k in overrides)


def _run_module(m: str, kwargs: dict):
    """Worker: import + run one module with stdout/stderr captured. Returns
    (stdout, stderr, traceback-or-None); the parent replays the streams in
    order."""
    out, err = io.StringIO(), io.StringIO()
    error = None
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            importlib.import_module(m).run(**kwargs)
    except Exception:
        error = traceback.format_exc()
    return out.getvalue(), err.getvalue(), error


def main(argv=None) -> int:
    """Run all (or the named) benchmark modules; return a shell exit code."""
    argv = list(argv) if argv else []
    overrides = {k: v for k, v in (("policy", _pop_value_flag(argv, "--policy")),
                                   ("hw", _pop_value_flag(argv, "--hw")))
                 if v is not None}
    device = _pop_value_flag(argv, "--device")
    jobs_s = _pop_value_flag(argv, "--jobs")
    try:
        jobs = max(1, int(jobs_s)) if jobs_s is not None else 1
    except ValueError:
        _usage(f"--jobs needs an integer, got {jobs_s!r}")
    if "--json" in argv:
        i = argv.index("--json")
        argv.pop(i)
        if (i < len(argv) and not argv[i].startswith("repro_torch.")
                and not argv[i].startswith("-")):
            os.environ["BENCH_JSON_DIR"] = argv.pop(i)
    if any(a.startswith("-") for a in argv):
        _usage(f"unknown option in {argv}")
    names = argv or MODULES
    kwargs = dict(overrides, **({"device": device} if device else {}))
    header()
    failed = []
    todo = []
    for m in names:
        # skip detection stays in the parent: one note per module
        if overrides and not _takes_overrides(m, overrides):
            print(f"# {m}: skipped (run() takes no "
                  f"{'/'.join(overrides)} overrides)", file=sys.stderr)
            continue
        todo.append(m)
    if jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as ex:
            futs = [(m, ex.submit(_run_module, m, kwargs)) for m in todo]
            for m, f in futs:
                try:
                    out, err, error = f.result()
                except BrokenProcessPool:
                    failed.append(m)
                    print(f"# {m}: worker process crashed", file=sys.stderr)
                    continue
                sys.stdout.write(out)
                sys.stderr.write(err)
                if error is not None:
                    failed.append(m)
                    sys.stderr.write(error)
    else:
        for m in todo:
            try:
                importlib.import_module(m).run(**kwargs)
            except Exception:
                failed.append(m)
                traceback.print_exc()
    if failed:
        print(f"benchmark failures: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
