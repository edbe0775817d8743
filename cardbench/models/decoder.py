"""The model module of every configuration file that names none
(``cardbench/lib/model.py``): the pre-norm decoder of ``weights.layout``,
``reference.Reference`` and ``counts`` (grouped-query attention over every
earlier key in each layer, one ``rope_theta``, a SwiGLU MLP or a top-k
mixture of SwiGLU experts with renormalized gates)."""
from cardbench.lib import counts, reference, weights
from cardbench.lib.counts import head_flops, span_flops, token_flops
from cardbench.lib.weights import layout

__all__ = ["layout", "walk", "span_flops", "token_flops", "head_flops",
           "paged_bytes"]


def paged_bytes(cfg: dict, decode_len) -> float:
    """Every layer attends all of each sequence's keys."""
    return cfg["num_layers"] * counts.paged_attention_bytes(cfg, decode_len)


def walk(cfg_file, sess, served, judged, seed, device, visit) -> None:
    """The reference over the judged tokens, ``visit(rid, j, final norm
    output, logits)`` for each: for a MoE model a replay of the served
    schedule (capacity drops couple the tokens routed together), for a
    dense one a causal pass a request."""
    cfg = cfg_file["arch"]
    W = weights.make(cfg, seed, device)
    ref = reference.Reference(cfg, W, cfg_file.get("policy", {}).get(
        "moe_capacity_factor", 1.25))
    if cfg.get("num_experts", 0):
        seqs = {q.rid: (q.prompt, served[q.rid]) for q in sess.reqs.values()}
        need = set(judged)
        last = max(i for i, s in enumerate(sess.steps)
                   if need & ({c[0] for c in s.chunks} | set(s.decode)))
        for rid, j, h, lg in ref.replay(
                [{"chunks": s.chunks, "decode": s.decode} for s in sess.steps],
                seqs, judged, last):
            visit(rid, j, h, lg)
    else:
        for rid in judged:
            prompt, toks = list(sess.reqs[rid].prompt), served[rid]
            h, lg = ref.sequence(prompt + toks[:-1], slice(
                len(prompt) - 1, len(prompt) + len(toks) - 1))
            for j in range(len(toks)):
                visit(rid, j, h[j], lg[j])
    del ref, W
