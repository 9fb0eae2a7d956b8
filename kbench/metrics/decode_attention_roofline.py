"""The decode attention kernel's share of its roofline in the profiled
slice: the summed least time of every call (``yardstick.decode_work``
over the bucket's kv lengths, one call per layer of each step) over the
kernel's summed device time; percent."""
from kbench.record import profiled
from kbench.yardstick import bound_s, decode_work


def read(rec):
    prof = rec["profile"]
    if prof is None or not prof["launches"].get("decode_attention"):
        return None
    m = rec["model"]
    total = 0.0
    for _, _, _, bucket, kvs in profiled(rec["decode_spans"], rec):
        f, b = decode_work(bucket, m["num_heads"], m["num_kv_heads"], m["head_dim"], sum(kvs))
        total += m["num_layers"] * bound_s(f, b)
    dev = prof["group_s"].get("decode_attention", 0.0)
    return 100.0 * total / dev if dev > 0 else None
