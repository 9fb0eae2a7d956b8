"""The prefill attention kernel's share of its roofline in the profiled
slice: the summed least time of every call (``yardstick.prefill_work`` at
the call's shapes, one call per layer of each chunk, each layer at its
attention window) over the kernel's summed device time; percent. Nothing
where the slice held no call."""
from kbench.record import profiled
from kbench.yardstick import bound_s, prefill_visible, prefill_work, window_groups


def read(rec):
    prof = rec["profile"]
    if prof is None or not prof["launches"].get("prefill_attention"):
        return None
    m = rec["model"]
    sq = m["engine"]["chunk_size"]
    groups = window_groups(m)
    total = 0.0
    for _, _, take, start in profiled(rec["prefill_spans"], rec):
        for window, layers in groups:
            vis, rows = prefill_visible([start], sq, [start + take], window)
            f, b = prefill_work(1, sq, m["num_heads"], m["num_kv_heads"], m["head_dim"], vis,
                                rows)
            total += layers * bound_s(f, b)
    dev = prof["group_s"].get("prefill_attention", 0.0)
    return 100.0 * total / dev if dev > 0 else None
