"""The model FLOPs of the prompt tokens computed in the window's prefill
chunks (``yardstick.model_flops``), over the chunks' host time, as a share
of the H100's dense bf16 peak; percent."""
from kbench.record import spans_in_window
from kbench.yardstick import PEAK_FLOPS_BF16, model_flops


def read(rec):
    sp = list(spans_in_window(rec["prefill_spans"], rec))
    t = sum(s[1] - s[0] for s in sp)
    if not sp or t <= 0:
        return None
    flops = sum(model_flops(rec["model"], start, take) for _, _, take, start in sp)
    return 100.0 * flops / t / PEAK_FLOPS_BF16
