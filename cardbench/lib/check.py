"""What decides ``correct``: the served tokens against the plain reference.

After the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed and holding the longest of
them, is judged token by token: each served token's logit under the
reference (the ``walk`` of the configuration's model module, ``model.py``;
by default ``models/decoder.py`` over ``reference.py``; fp32, TF32 off, its
weights made again from the seed) may lie below the reference's best logit
at that position by at most the cell's limit (``served_logit_gap``, in
logits). Served tokens are greedy, so a sound program's gap is rounding,
and a token produced wrong reads as a gap of the size of the logits'
spread.

``final_hidden_err`` is the widest relative gap, over the judged tokens,
between the final norm's output that the program's pass gave (a forward
hook on ``final_norm`` copies it to the host during the window,
``serve.Session.capture``) and the reference's: max |h - h_ref| / max
|h_ref| at each token; ``final_hidden_err_p50`` and ``_p90`` are the median
and the 90th percentile over the tokens. A cell compares those its limits
file gives a number.

Beside them, three counts with the limit 0: finished requests whose number
of served tokens is not the one asked for (``wrong_length``), steps where
what the harness saw the step do disagrees with the engine's own counters
(``counter_mismatch``), and judged tokens whose state the hook did not
capture (``state_uncaptured``): the hook has to see one call of
``final_norm`` for each pass that produces tokens, with one row a token. A
program that runs its passes otherwise (the norm folded into the head, a
CUDA graph replayed without module calls) leaves the state uncaptured, and
``correct`` cannot be decided until the capture follows it.

The control (``control=True``) is the same reference in TF32, put in the
program's place: at every judged position the token that TF32 ranks first
is read under the fp32 reference (``control_logit_gap``), and its final
norm output against the fp32 reference's (``control_hidden_err``).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from cardbench.lib import model

MANDATORY = ("served_logit_gap", "wrong_length", "counter_mismatch",
             "state_uncaptured")
UNCAPTURED = ("state capture unavailable: the hook on model.final_norm did "
              "not see one call, one row a token, for each pass that gave "
              "the judged tokens, so the program's states cannot be compared")
MIN_REQUESTS = 8
MAX_REQUESTS = 24
MIN_TOKENS = 400


def sample(sess, seed: int) -> List[int]:
    """rids of the judged requests: finished ones, the longest (prompt and
    served) first, then others in an order drawn from the seed until at
    least MIN_REQUESTS and MIN_TOKENS served tokens (at most
    MAX_REQUESTS)."""
    done = [q for q in sess.reqs.values()
            if q.done_t is not None and q.done_t <= sess.t_end]
    if not done:
        return []
    longest = max(done, key=lambda q: (len(q.prompt) + q.max_new, -q.rid))
    rest = [q for q in done if q.rid != longest.rid]
    order = np.random.default_rng([int(seed) % 2 ** 63, 0xC4EC]).permutation(
        len(rest))
    out, toks = [longest.rid], longest.max_new
    for i in order:
        if len(out) >= MAX_REQUESTS or (len(out) >= MIN_REQUESTS
                                        and toks >= MIN_TOKENS):
            break
        out.append(rest[i].rid)
        toks += rest[i].max_new
    return sorted(out)


def counts(sess, served: Dict[int, List[int]]) -> Dict[str, int]:
    wrong = sum(1 for q in sess.reqs.values()
                if q.done_t is not None and len(served[q.rid]) != q.max_new)
    mism = sum(1 for s in sess.steps
               if s.stats["decode_tokens"] != len(s.decode)
               or s.stats["prefill_chunks"] != len(s.chunks)
               or s.stats["decode_batches"] != int(bool(s.decode)))
    return {"wrong_length": wrong, "counter_mismatch": mism}


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _quantiles(name: str, errs: List[float]) -> Dict[str, float]:
    """The widest, the median and the 90th percentile of per-token
    errors (inf where there are none)."""
    if not errs:
        return {name: math.inf, name + "_p50": math.inf, name + "_p90": math.inf}
    a = np.asarray(errs)
    return {name: float(a.max()), name + "_p50": float(np.percentile(a, 50)),
            name + "_p90": float(np.percentile(a, 90))}


def judge(cfg_file, sess, served, seed: int, device, limits: dict,
          control: bool = False) -> dict:
    """{"correct", "checks": {name: {"value", "limit"}} of the compared
    numbers, "readings": every number}."""
    judged = sample(sess, seed)
    walk = model.load(cfg_file).walk
    tf32 = torch.backends.cuda.matmul.allow_tf32
    ctrl = {}
    v = {"served_logit_gap": 0.0 if judged else math.inf}
    c = {"control_logit_gap": 0.0}
    errs, cerrs = [], []
    missing = [0]

    def keep(rid, j, h, lg):
        ctrl[(rid, j)] = (int(torch.argmax(lg)), h.clone())

    def visit(rid, j, h, lg):
        top = float(lg.max())
        v["served_logit_gap"] = max(v["served_logit_gap"],
                                    top - float(lg[served[rid][j]]))
        got = sess.state((rid, j))
        if got is None:
            missing[0] += 1
        else:
            errs.append(_rel(got.to(h.device), h))
        if control:
            tok, hc = ctrl[(rid, j)]
            c["control_logit_gap"] = max(c["control_logit_gap"],
                                         top - float(lg[tok]))
            cerrs.append(_rel(hc, h))
    try:
        if control and judged:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            walk(cfg_file, sess, served, judged, seed, device, keep)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if judged:
            walk(cfg_file, sess, served, judged, seed, device, visit)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    v.update(_quantiles("final_hidden_err", errs))
    c.update(_quantiles("control_hidden_err", cerrs))
    v.update(counts(sess, served))
    v["state_uncaptured"] = missing[0]
    # compared: every number with a limit; those of MANDATORY always are
    named = {k: x for k, x in limits.items() if isinstance(x, (int, float))}
    checks = {k: {"value": v[k], "limit": named.get(
        k, None if k == "served_logit_gap" else 0)}
              for k in v if k in named or k in MANDATORY}
    ok = all(x["limit"] is not None and x["value"] <= x["limit"]
             for x in checks.values())
    return {"correct": ok, "checks": checks, "readings": dict(v, **(
        c if control else {})), "judged_requests": len(judged),
        "judged_tokens": sum(len(served[r]) for r in judged)}
