"""Requests decoded per ``DECODE_STEP`` in the window: all decoded tokens
over all steps. Traced run."""


def read(rec):
    t0, t1 = rec["window"]
    b = [batch for t, batch, _ in rec["steps"] if t0 <= t <= t1]
    return sum(b) / len(b) if b else None
