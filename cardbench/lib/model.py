"""A configuration's model module: the weight layout, the plain reference
and the counts of the architecture it runs.

A configuration file may name ``"model": "cardbench/models/<file>.py"``, a
path from the root of the checkout; a file that names none gets
``cardbench/models/decoder.py`` (the decoder of ``weights``, ``reference``
and ``counts``). The module is loaded by path, as ``metrics.reader`` loads
a metric's reader, so a new architecture comes as new files. It supplies:

- ``layout(cfg)``: (name, shape, fan_in) of every parameter, named as the
  port's ``TransformerLM`` names it, in the order ``weights.make`` draws
  them (fan_in 0: a norm scale, ones);
- ``walk(cfg_file, sess, served, judged, seed, device, visit)``: the plain
  fp32 reference over the judged tokens, calling ``visit(rid, j, final norm
  output, logits)`` for each; it makes its weights again from the seed
  (``make_weights``) and decides for itself whether it follows the served
  schedule (``serve.Session.steps``) or runs each sequence whole;
- ``span_flops(cfg, start, end)``, ``token_flops(cfg, position)`` and
  ``head_flops(cfg)``: the FLOPs the readers count, by ``counts``' rules;
- ``paged_bytes(cfg, decode_len)``: the bytes of one decode pass's
  paged-attention calls over all its layers, each sequence attending
  ``decode_len`` keys (a windowed layer caps them at its window).

A model module is plain ``torch`` and may import ``cardbench.lib``; one that
imports the program (``repro_torch``), JAX or the JAX package is refused
before it runs (``guard.refused_imports``).
"""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from types import ModuleType

from cardbench.lib import guard, weights

ROOT = Path(__file__).resolve().parents[2]
DEFAULT = "cardbench/models/decoder.py"
NEEDS = ("layout", "walk", "span_flops", "token_flops", "head_flops",
         "paged_bytes")


def load(cfg_file: dict) -> ModuleType:
    """The model module ``cfg_file`` names (loaded once a process)."""
    return _load((ROOT / cfg_file.get("model", DEFAULT)).resolve())


@functools.cache
def _load(path: Path) -> ModuleType:
    bad = guard.refused_imports(path.read_text())
    if bad:
        raise ImportError(f"model module {path.name} refused: a model module "
                          f"is plain torch, and this one uses {', '.join(bad)}")
    spec = importlib.util.spec_from_file_location(
        "cardbench_model_" + path.stem.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [n for n in NEEDS if not callable(getattr(mod, n, None))]
    if missing:
        raise ImportError(f"model module {path.name} lacks {', '.join(missing)}")
    return mod


def make_weights(cfg_file: dict, seed: int, device):
    """The configuration's state dict for ``seed`` on ``device``, drawn by
    ``weights.make`` from its model module's layout."""
    cfg = cfg_file["arch"]
    return weights.make(cfg, seed, device, spec=load(cfg_file).layout(cfg))
