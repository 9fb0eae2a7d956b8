"""The frozen yardstick equals the port's at the commit that froze it: the
attention kernels' work, the H100 peaks, the parameter count behind the
model-FLOPs formula and its attention term. With attention windows, it
counts what a brute-force walk over the (query, key) pairs counts."""
import json
from pathlib import Path

import numpy as np
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
    vis, rows = ys.prefill_visible([start], sq, [start + take], window=0)
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


def _seen(starts, sq, kv_lens, window):
    """(pairs, rows) by brute force: the (q, k) with k < kv, k <= q and,
    in a windowed layer, q - k < window; the rows are the k some q sees."""
    pairs = rows = 0
    for st, kv in zip(starts, kv_lens):
        q = np.arange(st, st + sq)[:, None]
        k = np.arange(kv)[None, :]
        seen = (k <= q) & ((q - k < window) if window else True)
        pairs += int(seen.sum())
        rows += int(seen.any(0).sum())
    return pairs, rows


@pytest.mark.parametrize("window", [0, 1, 2, 7, 64, 512, 1024, 5000])
@pytest.mark.parametrize("starts,sq,kv_lens", [
    ([0], 512, [512]), ([1536], 512, [1836]), ([20000], 512, [20512]), ([3000], 1, [3001]),
    ([0, 5, 200, 6], 16, [16, 9, 216, 3]),  # padding rows; a sequence shorter than its start
    ([70], 64, [100]), ([0], 64, [1])])
def test_prefill_visible_counts_the_pairs_each_query_sees(starts, sq, kv_lens, window):
    got = ys.prefill_visible(starts, sq, kv_lens, window)
    assert got == _seen(starts, sq, kv_lens, window)
    if window == 0:
        q_pos = torch.tensor(starts, dtype=torch.int32)[:, None] + torch.arange(sq)[None]
        kv = torch.tensor(kv_lens, dtype=torch.int32)
        assert got == visible_rows(q_pos.int(), kv, max(kv_lens))
    if window > max(s + sq for s in starts):  # wider than the context: binds nowhere
        assert got == ys.prefill_visible(starts, sq, kv_lens)


@pytest.mark.parametrize("window", [0, 1, 300, 5000])
def test_decode_rows_read_at_most_the_window(window):
    kvs = [4096, 1, 300, 17, 2048]
    assert ys.decode_rows(kvs, window) == sum(min(k, window or k) for k in kvs)


MELLUM = [1024 if i % 4 != 3 else 0 for i in range(40)]  # minicpm's 40 layers, 3 in 4 windowed


@pytest.mark.parametrize("windows", [None, MELLUM, [7] * 40, [0, 5000] * 20])
def test_model_flops_is_additive_over_chunks(windows):
    cfg = json.loads(CONFIGS[0].read_text())
    if windows is not None:
        cfg["attention_windows"] = windows
    whole = ys.model_flops(cfg, 0, 3000)
    parts = sum(ys.model_flops(cfg, st, min(512, 3000 - st)) for st in range(0, 3000, 512))
    assert whole == pytest.approx(parts, rel=1e-12)
    tokens = sum(ys.model_flops(cfg, p, 1) for p in range(3000))
    assert whole == pytest.approx(tokens, rel=1e-12)


def test_model_flops_counts_each_layer_at_its_window():
    cfg = dict(json.loads(CONFIGS[0].read_text()), attention_windows=MELLUM)
    hq, dh = cfg["num_heads"], cfg["head_dim"]
    start, n = 20000, 512
    per_layer = sum(4.0 * hq * dh * _seen([start], n, [start + n], w)[0] for w in MELLUM)
    want = 2.0 * ys.active_params_nonembed(cfg) * n + per_layer
    assert ys.model_flops(cfg, start, n) == pytest.approx(want, rel=1e-12)
    full = dict(cfg, attention_windows=None)
    assert ys.model_flops(cfg, start, n) < ys.model_flops(full, start, n)


def test_no_windows_are_every_layer_full():
    cfg = json.loads(CONFIGS[0].read_text())
    assert ys.layer_windows(cfg) == [0] * cfg["num_layers"]
    assert ys.window_groups(cfg) == [(0, cfg["num_layers"])]
    assert ys.window_groups(dict(cfg, attention_windows=MELLUM)) == [(1024, 30), (0, 10)]


@pytest.mark.parametrize("windows", [[0] * 39, [0] * 39 + [-1], [0] * 39 + [1.5],
                                     [0] * 39 + [True]])
def test_windows_that_are_not_one_whole_number_a_layer_fail(windows):
    cfg = dict(json.loads(CONFIGS[0].read_text()), attention_windows=windows)
    with pytest.raises(ValueError, match="configuration 'minicpm-2b': attention_windows"):
        ys.layer_windows(cfg)


def test_percentile():
    assert ys.percentile([1.0], 95) is None
    assert ys.percentile([0.0, 1.0], 50) == pytest.approx(0.5)
    assert ys.percentile(range(101), 95) == pytest.approx(95.0)
