"""A model module that a test owns (``test_cardbench_models.py``): the
decoder of ``models/decoder.py`` with a bias on q, k and v (``qkv_bias``,
the port's ``mixer.bq``/``bk``/``bv``), added before the qk-norm and RoPE
as the port adds it. The default layout has no biases, so the port cannot
load its weights from it (``load_state_dict(strict=True)``)."""
import torch

from cardbench.lib import counts, reference, weights
from cardbench.lib.counts import head_flops, span_flops, token_flops

__all__ = ["layout", "walk", "span_flops", "token_flops", "head_flops",
           "paged_bytes"]


def layout(cfg: dict):
    """The decoder's parameters and, after each layer's ``mixer.wv``, its
    biases: N(0, 1/head_dim)."""
    H, Hkv, D = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    out = []
    for name, shape, fan in weights.layout(cfg):
        out.append((name, shape, fan))
        if name.endswith(".mixer.wv"):
            p = name[:-len("wv")]
            out += [(p + "bq", (H, D), D), (p + "bk", (Hkv, D), D),
                    (p + "bv", (Hkv, D), D)]
    return out


def paged_bytes(cfg: dict, decode_len) -> float:
    return cfg["num_layers"] * counts.paged_attention_bytes(cfg, decode_len)


class _Biased(reference.Reference):
    def _qkv(self, p, h, cs):
        W = self.W
        q = torch.einsum("td,dhe->the", h, W[p + "mixer.wq"]) + W[p + "mixer.bq"]
        k = torch.einsum("td,dhe->the", h, W[p + "mixer.wk"]) + W[p + "mixer.bk"]
        v = torch.einsum("td,dhe->the", h, W[p + "mixer.wv"]) + W[p + "mixer.bv"]
        if self.cfg.get("qk_norm"):
            q = reference.rmsnorm(q, W[p + "mixer.q_norm"])
            k = reference.rmsnorm(k, W[p + "mixer.k_norm"])
        return reference.rope(q, cs), reference.rope(k, cs), v


def walk(cfg_file, sess, served, judged, seed, device, visit) -> None:
    """A causal pass a judged request (a dense model)."""
    cfg = cfg_file["arch"]
    ref = _Biased(cfg, weights.make(cfg, seed, device, spec=layout(cfg)))
    for rid in judged:
        prompt, toks = list(sess.reqs[rid].prompt), served[rid]
        h, lg = ref.sequence(prompt + toks[:-1], slice(
            len(prompt) - 1, len(prompt) + len(toks) - 1))
        for j in range(len(toks)):
            visit(rid, j, h[j], lg[j])
