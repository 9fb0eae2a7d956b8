"""Host time of the prefill chunks that ended in the window (each ends in
a device sync), per 1000 prompt tokens they computed; milliseconds."""
from kbench.record import spans_in_window


def read(rec):
    sp = list(spans_in_window(rec["prefill_spans"], rec))
    tok = sum(s[2] for s in sp)
    return 1e6 * sum(s[1] - s[0] for s in sp) / tok if tok else None
