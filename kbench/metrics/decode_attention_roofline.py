"""The decode attention kernel's share of its roofline in the profiled
slice: the summed least time of every call (``yardstick.decode_work``
over the rows the bucket's lanes read, one call per layer of each step,
each layer at its attention window) over the kernel's summed device time;
percent."""
from kbench.record import profiled
from kbench.yardstick import bound_s, decode_rows, decode_work, window_groups


def read(rec):
    prof = rec["profile"]
    if prof is None or not prof["launches"].get("decode_attention"):
        return None
    m = rec["model"]
    groups = window_groups(m)
    total = 0.0
    for _, _, _, bucket, kvs in profiled(rec["decode_spans"], rec):
        for window, layers in groups:
            f, b = decode_work(bucket, m["num_heads"], m["num_kv_heads"], m["head_dim"],
                               decode_rows(kvs, window))
            total += layers * bound_s(f, b)
    dev = prof["group_s"].get("decode_attention", 0.0)
    return 100.0 * total / dev if dev > 0 else None
