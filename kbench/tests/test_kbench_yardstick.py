"""The frozen yardstick equals the port's at the commit that froze it: the
attention kernels' work, the H100 peaks, the parameter count behind the
model-FLOPs formula and its attention term."""
import json
from pathlib import Path

import pytest
import torch

from kbench import yardstick as ys
from kbench.bench import model_config
from repro_torch.kernels.decode_attention.ops import work as port_decode_work
from repro_torch.kernels.prefill_attention.ops import visible_rows
from repro_torch.kernels.prefill_attention.ops import work as port_prefill_work
from repro_torch.roofline.analysis import bound, train_flops
from repro_torch.roofline.hw import H100

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.json"))


def test_peaks_equal_the_ports():
    assert ys.PEAK_FLOPS_BF16 == H100.peak_flops_bf16
    assert ys.HBM_BYTES_PER_S == H100.hbm_bw
    for f, b in [(1e12, 1e6), (1e6, 1e10)]:
        assert 1e3 * ys.bound_s(f, b) == pytest.approx(bound(f, b, torch.bfloat16)[0])


@pytest.mark.parametrize("start,take,sq", [(0, 512, 512), (1536, 300, 512), (4000, 95, 512),
                                           (0, 1, 64), (70, 64, 64)])
@pytest.mark.parametrize("heads", [(36, 36, 64), (32, 8, 128)])
def test_prefill_work_equals_the_ports(start, take, sq, heads):
    hq, hkv, dh = heads
    q_pos = (start + torch.arange(sq, dtype=torch.int32))[None]
    kv_len = torch.tensor([start + take], dtype=torch.int32)
    vis, rows = ys.prefill_visible([start], sq, [start + take])
    assert (vis, rows) == visible_rows(q_pos, kv_len, start + sq)
    assert ys.prefill_work(1, sq, hq, hkv, dh, vis, rows) == \
        port_prefill_work(1, sq, hq, hkv, dh, vis, rows)


@pytest.mark.parametrize("b,tot", [(1, 1), (16, 40000), (8, 131072)])
@pytest.mark.parametrize("heads", [(36, 36, 64), (32, 8, 128)])
def test_decode_work_equals_the_ports(b, tot, heads):
    assert ys.decode_work(b, *heads, tot) == port_decode_work(b, *heads, tot)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_active_params_equal_the_ports(path):
    cfg = json.loads(path.read_text())
    mc = model_config(cfg)
    embed = mc.vocab_size * mc.d_model * (1 if mc.tie_embeddings else 2)
    # the port's count puts 2 d per layer for the norms and d for the final norm,
    # as the frozen count does
    assert ys.active_params_nonembed(cfg) + embed == mc.count_active_params()


DENSE = [p for p in CONFIGS if not json.loads(p.read_text()).get("num_experts")]


@pytest.mark.parametrize("path", DENSE, ids=lambda p: p.stem)
def test_attention_term_matches_the_ports_training_count(path):
    """For a dense model, three forward passes of the frozen formula over a
    whole sequence (backward = 2 forwards) plus the embedding's 6 per token
    give the port's training FLOPs, up to the diagonal the causal count
    adds (6 L H Dh per token). Dense configurations only: the port's
    training count takes every expert, the frozen one the top-k."""
    cfg = json.loads(path.read_text())
    mc = model_config(cfg)
    s = 2048
    embed = mc.vocab_size * mc.d_model * (1 if mc.tie_embeddings else 2)
    diag = 6 * mc.num_layers * mc.num_heads * mc.resolved_head_dim * s
    mine = 3 * ys.model_flops(cfg, 0, s) + 6 * embed * s - diag
    assert mine == pytest.approx(train_flops(mc, None, s, s), rel=1e-12)


def test_model_flops_is_additive_over_chunks():
    cfg = json.loads(CONFIGS[0].read_text())
    whole = ys.model_flops(cfg, 0, 1536)
    parts = sum(ys.model_flops(cfg, st, 512) for st in (0, 512, 1024))
    assert whole == pytest.approx(parts)


def test_percentile():
    assert ys.percentile([1.0], 95) is None
    assert ys.percentile([0.0, 1.0], 50) == pytest.approx(0.5)
    assert ys.percentile(range(101), 95) == pytest.approx(95.0)
