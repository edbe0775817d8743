"""The port's figure modules print, on the CPU, the same CSV text as the JAX
package's: their numbers are modeled charges, equal on every device."""
import contextlib
import importlib
import io
import sys
from pathlib import Path

import jax  # noqa: F401  (each port test file runs beside JAX)
import pytest
import torch  # noqa: F401

# the JAX package's benchmarks/ lives at the root of the checkout
sys.path.append(str(Path(__file__).resolve().parent.parent))


def _csv(module: str, **kw) -> str:
    """What ``module.run(**kw)`` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(module).run(**kw)
    return buf.getvalue()


@pytest.mark.parametrize("name,rows", [
    ("fig3_overview", 12),         # six apps x managed/system
    ("fig45_timeline", 4),
    ("fig67_pagesize", 15),        # five apps x (4K, 64K, ratios)
    ("fig89_qiskit", 10),
    ("fig10_srad_migration", 25),  # 2 x 12 iterations + the crossover
    ("fig11_oversub", 24),         # six apps x four ratios
    ("fig1213_prefetch", 6),
])
def test_figure_csv_equals_jax(name, rows):
    got = _csv(f"repro_torch.bench.{name}", device="cpu")
    assert got == _csv(f"benchmarks.{name}")
    assert len(got.splitlines()) == rows


@pytest.mark.parametrize("policy,hw", [("mi300a_unified", "mi300a"),
                                       ("managed", None)])
def test_fig3_csv_equals_jax_under_overrides(policy, hw):
    got = _csv("repro_torch.bench.fig3_overview", policy=policy, hw=hw,
               device="cpu")
    assert got == _csv("benchmarks.fig3_overview", policy=policy, hw=hw)
    assert ("hw=" in got) == (hw is not None)
