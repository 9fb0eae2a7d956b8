"""Each metric reader's arithmetic on a hand-made record."""
import json
from pathlib import Path

import pytest

from kbench.spec import reader
from kbench.yardstick import PEAK_FLOPS_BF16, active_params_nonembed, bound_s, decode_work, \
    model_flops, prefill_visible, prefill_work

CONFIGS = {p.stem: json.loads(p.read_text())
           for p in (Path(__file__).resolve().parents[1] / "configs").glob("*.json")}

MODEL = dict(num_layers=2, d_model=8, num_heads=2, num_kv_heads=1, head_dim=4, d_ff=16,
             vocab_size=32, num_experts=0, engine=dict(chunk_size=4))


def rec(**kw):
    base = dict(window=(10.0, 20.0), rows=[], prefill_spans=[], decode_spans=[], steps=[],
                model=MODEL, setup_s=12.5, profile=None)
    base.update(kw)
    return base


def row(due, times, prefill_start=None):
    return dict(due=due, times=times, prefill_start=prefill_start)


def test_ttft_counts_from_due_and_censors_at_the_window_end():
    rows = [row(5.0, [6.0, 7.0]),        # due before the window: not counted
            row(11.0, [12.0, 12.5]),     # 1.0
            row(12.0, [15.0]),           # 3.0
            row(18.0, []),               # no token: 20 - 18 = 2.0
            row(19.0, [21.0])]           # token after the end: 1.0
    # the median of [1, 1, 2, 3]
    assert reader("ttft_p50_s")(rec(rows=rows)) == pytest.approx(1.5)


def test_tpot_over_tokens_inside_the_window():
    rows = [row(0.0, [9.0, 10.0, 10.1, 10.2]),   # in-window 10.0..10.2: 0.1 s
            row(11.0, [11.5, 12.5]),             # 1.0 s
            row(12.0, [19.9, 20.5])]             # one token inside: not counted
    v = reader("tpot_p95_ms")(rec(rows=rows))
    assert v == pytest.approx(1e3 * (0.1 + 0.95 * 0.9))


def test_output_tokens_per_s():
    rows = [row(0.0, [9.0, 10.0, 10.1]), row(11.0, [11.5, 12.5, 20.5])]
    assert reader("output_tokens_per_s")(rec(rows=rows)) == pytest.approx(4 / 10.0)


def test_setup():
    assert reader("setup_s")(rec()) == 12.5


def test_prefill_queue_from_prefill_start():
    rows = [row(11.0, [13.0], prefill_start=11.5), row(12.0, [], prefill_start=None),
            row(4.0, [], prefill_start=4.5)]
    steps = [(12.0, 2, 0.1)]
    v = reader("prefill_queue_p95_s")(rec(rows=rows, steps=steps))
    assert v == pytest.approx(0.5 + 0.95 * (8.0 - 0.5))
    assert reader("prefill_queue_p95_s")(rec(rows=rows)) is None  # untraced run


def test_decode_step_and_batch():
    steps = [(9.0, 8, 1.0), (11.0, 4, 0.05), (12.0, 2, 0.15), (21.0, 1, 9.0)]
    r = rec(steps=steps)
    assert reader("decode_batch_mean")(r) == pytest.approx(3.0)
    assert reader("decode_step_ms")(r) == pytest.approx(100.0)


def test_prefill_ms_per_ktok_and_mfu():
    spans = [(9.0, 9.5, 4, 0), (10.0, 10.2, 4, 4), (12.0, 12.3, 2, 8)]
    r = rec(prefill_spans=spans)
    assert reader("prefill_ms_per_ktok")(r) == pytest.approx(1e6 * 0.5 / 6)
    f = model_flops(MODEL, 4, 4) + model_flops(MODEL, 8, 2)
    assert reader("mfu.prefill")(r) == pytest.approx(100 * f / 0.5 / PEAK_FLOPS_BF16)


def test_mfu_decode_counts_real_lanes_at_their_positions():
    spans = [(10.0, 10.1, 2, 4, [7, 3, 1, 1]), (30.0, 30.1, 1, 1, [5])]
    f = model_flops(MODEL, 6, 1) + model_flops(MODEL, 2, 1)
    assert reader("mfu.decode")(rec(decode_spans=spans)) == \
        pytest.approx(100 * f / 0.1 / PEAK_FLOPS_BF16)


def _profile(**kw):
    p = dict(window_s=2.0, busy_s=1.5, group_s={"prefill_attention": 0.01,
                                                "decode_attention": 0.02},
             launches={"prefill_attention": 4, "decode_attention": 2}, span=(11.0, 13.0))
    p.update(kw)
    return p


def test_rooflines_sum_the_bounds_of_the_profiled_calls():
    pre = [(11.5, 11.6, 4, 0), (11.7, 11.8, 3, 4), (14.0, 14.1, 4, 7)]  # last outside
    dec = [(12.0, 12.1, 2, 2, [9, 5])]
    r = rec(prefill_spans=pre, decode_spans=dec, profile=_profile())
    exp = 0.0
    for _, _, take, start in pre[:2]:
        vis, rows = prefill_visible([start], 4, [start + take])
        exp += 2 * bound_s(*prefill_work(1, 4, 2, 1, 4, vis, rows))
    assert reader("prefill_attention_roofline")(r) == pytest.approx(100 * exp / 0.01)
    exp = 2 * bound_s(*decode_work(2, 2, 1, 4, 14))
    assert reader("decode_attention_roofline")(r) == pytest.approx(100 * exp / 0.02)


def test_readers_give_nothing_without_a_profile_or_calls():
    assert reader("prefill_attention_roofline")(rec()) is None
    p = _profile(launches={"prefill_attention": 0, "decode_attention": 0})
    assert reader("decode_attention_roofline")(rec(profile=p)) is None
    assert reader("device_idle_share")(rec()) is None


def test_idle_share():
    assert reader("device_idle_share")(rec(profile=_profile())) == pytest.approx(25.0)


# the counting readers before layers had windows: every layer full causal attention
def _full_visible(st, sq, kv):
    below = min(sq, max(0, kv - st))
    return below * st + below * (below + 1) // 2 + (sq - below) * kv, min(st + sq, kv)


def _full_flops(m, start, n):
    pairs = n * start + n * (n + 1) // 2
    return (2.0 * active_params_nonembed(m) * n
            + 4.0 * m["num_layers"] * m["num_heads"] * m["head_dim"] * pairs)


def _counted(m):
    """A traced record of served work at ``m``'s shapes: prefill chunks of
    its chunk size, whole and partial, up to 3,600 tokens deep; decode steps
    at each bucket with lanes up to 4,000 rows."""
    sq = m["engine"]["chunk_size"]
    pre = [(11.0 + 0.01 * i, 11.005 + 0.01 * i, take, start)
           for i, (start, take) in enumerate([(0, sq), (sq, sq), (3 * sq, 100), (3600, sq),
                                              (7, 1)])]
    dec = []
    for i, b in enumerate(m["engine"]["decode_buckets"]):
        lanes = max(1, b - 1)
        kvs = [4000 - 251 * j for j in range(lanes)] + [1] * (b - lanes)
        dec.append((12.0 + 0.01 * i, 12.005 + 0.01 * i, lanes, b, kvs))
    p = _profile(group_s={"prefill_attention": 0.0123, "decode_attention": 0.0456},
                 launches={"prefill_attention": 5, "decode_attention": 5})
    return rec(model=m, prefill_spans=pre, decode_spans=dec, profile=p)


def _full_readings(m, r):
    sq = m["engine"]["chunk_size"]
    pre = 0.0
    for _, _, take, start in r["prefill_spans"]:
        vis, rows = _full_visible(start, sq, start + take)
        f, b = prefill_work(1, sq, m["num_heads"], m["num_kv_heads"], m["head_dim"], vis, rows)
        pre += m["num_layers"] * bound_s(f, b)
    dec = 0.0
    for _, _, _, bucket, kvs in r["decode_spans"]:
        f, b = decode_work(bucket, m["num_heads"], m["num_kv_heads"], m["head_dim"], sum(kvs))
        dec += m["num_layers"] * bound_s(f, b)
    pf = sum(_full_flops(m, start, take) for _, _, take, start in r["prefill_spans"])
    df = sum(_full_flops(m, kv - 1, 1) for _, _, lanes, _, kvs in r["decode_spans"]
             for kv in kvs[:lanes])
    t_pre = sum(s[1] - s[0] for s in r["prefill_spans"])
    t_dec = sum(s[1] - s[0] for s in r["decode_spans"])
    return {"prefill_attention_roofline": 100.0 * pre / 0.0123,
            "decode_attention_roofline": 100.0 * dec / 0.0456,
            "mfu.prefill": 100.0 * pf / t_pre / PEAK_FLOPS_BF16,
            "mfu.decode": 100.0 * df / t_dec / PEAK_FLOPS_BF16}


COUNTING = ["prefill_attention_roofline", "decode_attention_roofline", "mfu.prefill",
            "mfu.decode"]


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", COUNTING)
def test_counting_readers_read_as_before_where_no_layer_has_a_window(config, name):
    m = CONFIGS[config]
    assert "attention_windows" not in m
    r = _counted(m)
    assert reader(name)(r) == _full_readings(m, r)[name]  # float for float


def _per_layer_readings(m, r, windows):
    """The same readings, layer by layer, each layer at its own window."""
    sq = m["engine"]["chunk_size"]
    hq, hkv, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    pre = sum(bound_s(*prefill_work(1, sq, hq, hkv, dh,
                                    *prefill_visible([start], sq, [start + take], w)))
              for _, _, take, start in r["prefill_spans"] for w in windows)
    dec = sum(bound_s(*decode_work(bucket, hq, hkv, dh, sum(min(kv, w or kv) for kv in kvs)))
              for _, _, _, bucket, kvs in r["decode_spans"] for w in windows)
    attn = lambda st, n: sum(4.0 * hq * dh * prefill_visible([st], n, [st + n], w)[0]  # noqa
                             for w in windows)
    flops = lambda st, n: 2.0 * active_params_nonembed(m) * n + attn(st, n)  # noqa: E731
    pf = sum(flops(start, take) for _, _, take, start in r["prefill_spans"])
    df = sum(flops(kv - 1, 1) for _, _, lanes, _, kvs in r["decode_spans"] for kv in kvs[:lanes])
    t_pre = sum(s[1] - s[0] for s in r["prefill_spans"])
    t_dec = sum(s[1] - s[0] for s in r["decode_spans"])
    return {"prefill_attention_roofline": 100.0 * pre / 0.0123,
            "decode_attention_roofline": 100.0 * dec / 0.0456,
            "mfu.prefill": 100.0 * pf / t_pre / PEAK_FLOPS_BF16,
            "mfu.decode": 100.0 * df / t_dec / PEAK_FLOPS_BF16}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", COUNTING)
def test_counting_readers_count_each_layer_at_its_window(config, name):
    m = CONFIGS[config]
    windows = [1024 if i % 4 != 3 else 0 for i in range(m["num_layers"])]
    r = _counted(dict(m, attention_windows=windows))
    got = reader(name)(r)
    assert got == pytest.approx(_per_layer_readings(m, r, windows)[name], rel=1e-12)
    assert got < reader(name)(_counted(m))  # less work than every layer full
