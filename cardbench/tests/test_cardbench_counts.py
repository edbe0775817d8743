"""FLOP and byte counts against hand-worked shapes."""
import json
from pathlib import Path

import pytest

from cardbench.lib import counts, weights

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
TINY = {"num_layers": 2, "d_model": 8, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 2, "d_ff": 16, "vocab_size": 10}


def test_dense_token_flops_by_hand():
    # q 8*4*2, k and v 8*2*2 each, o 4*2*8: 112; MLP 3*8*16 = 384
    assert counts.layer_matmul_params(TINY) == 64 + 32 + 32 + 64 + 384
    per_layer = 2 * (64 + 32 + 32 + 64 + 384) + 4 * 3 * 4 * 2  # position 2
    assert counts.token_flops(TINY, 2) == 2 * per_layer
    assert counts.head_flops(TINY) == 2 * 8 * 10


def test_moe_counts_active_experts_only():
    cfg = dict(TINY, num_experts=6, top_k=2)
    assert counts.layer_matmul_params(cfg) == 64 + 32 + 32 + 64 + 8 * 6 + 2 * 3 * 8 * 16


def test_span_is_the_sum_of_its_tokens():
    assert counts.span_flops(TINY, 5, 12) == pytest.approx(
        sum(counts.token_flops(TINY, p) for p in range(5, 12)))
    assert counts.span_flops(TINY, 3, 3) == 0.0


def test_paged_attention_bytes_by_hand():
    # q and out: 2 * 3 seqs * 4 heads * 2 dims * 4 B; K and V: 2 * 10 tokens * 2 heads * 2 dims * 4 B
    assert counts.paged_attention_bytes(TINY, [1, 4, 5]) == 2 * 3 * 4 * 2 * 4 + 2 * 10 * 2 * 2 * 4


@pytest.mark.parametrize("name", ["yi-6b", "olmoe-1b-7b"])
def test_parameter_count_is_the_ports(name):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import TransformerLM
    arch = json.loads((CONFIGS / f"{name}.json").read_text())["arch"]
    model = TransformerLM(ArchConfig(**arch), device="meta")
    assert weights.param_count(arch) == sum(p.numel() for p in model.parameters())
    assert set(model.state_dict()) == {n for n, _, _ in weights.layout(arch)}


@pytest.mark.parametrize("name,gflop", [("yi-6b", 11.0), ("olmoe-1b-7b", 2.2)])
def test_full_width_flops_a_token(name, gflop):
    """yi-6b: 5.64 B matmul parameters outside embedding and head, so about
    11.3 GFLOP a token; olmoe-1b-7b: 1.07 B active, about 2.1 GFLOP (plus
    0.2 for its head)."""
    arch = json.loads((CONFIGS / f"{name}.json").read_text())["arch"]
    f = counts.token_flops(arch, 0) / 1e9
    assert gflop * 0.9 < f < gflop * 1.1
