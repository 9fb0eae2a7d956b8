"""The model FLOPs of the tokens the window's decode steps produced (real
lanes only, each at its position), over the steps' host time, as a share
of the H100's dense bf16 peak; percent."""
from kbench.record import spans_in_window
from kbench.yardstick import PEAK_FLOPS_BF16, model_flops


def read(rec):
    sp = list(spans_in_window(rec["decode_spans"], rec))
    t = sum(s[1] - s[0] for s in sp)
    if not sp or t <= 0:
        return None
    flops = sum(model_flops(rec["model"], kv - 1, 1)
                for _, _, lanes, _, kvs in sp for kv in kvs[:lanes])
    return 100.0 * flops / t / PEAK_FLOPS_BF16
