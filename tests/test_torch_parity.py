"""Charge parity of the port: all 66 fig3/fig11 configurations of the six
apps, run through the port on the CPU, are bit-identical to
tests/fixtures/parity.json (the JAX package's golden fixture)."""
import json
from pathlib import Path

import jax  # noqa: F401  (each port test file runs beside JAX)
import pytest
import torch  # noqa: F401

from repro_torch.apps import APPS, charge_snapshot

FIXTURE = Path(__file__).parent / "fixtures" / "parity.json"
KB = 1024
FIG11_RATIOS = (1.2, 1.5, 2.0, 3.0)


def _configs():
    """(key, app, policy, kwargs) as scripts/check_parity.py enumerates them."""
    for name, spec in APPS.items():
        for pol in ("explicit", "managed", "system"):
            yield f"fig3/{name}/{pol}", name, pol, dict(spec.sizes["fig3"])
    for name, spec in APPS.items():
        for ratio in FIG11_RATIOS:
            for pol in ("system", "managed"):
                yield (f"fig11/{name}/oversub{ratio}/{pol}", name, pol,
                       dict(spec.sizes["fig11"], oversub_ratio=ratio,
                            page_size=4 * KB))


CONFIGS = list(_configs())


@pytest.fixture(scope="module")
def fixture():
    return json.loads(FIXTURE.read_text())


def test_port_covers_33_fixture_configs(fixture):
    """The 33 configurations of the first slice's apps are all there."""
    first = [c for c in CONFIGS if c[1] in ("hotspot", "srad", "qiskit")]
    assert len(first) == 33
    assert all(key in fixture for key, *_ in first)


def test_port_covers_all_66_fixture_configs(fixture):
    assert len(CONFIGS) == 66
    assert sorted(key for key, *_ in CONFIGS) == sorted(fixture)


@pytest.mark.parametrize("key,app,pol,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_charges_bit_identical_to_fixture(key, app, pol, kw, fixture):
    got = charge_snapshot(APPS[app].run(pol, device="cpu", **kw))
    for section in fixture[key]:
        assert got[section] == fixture[key][section], f"{key}: {section} drifted"
    assert got == fixture[key]
