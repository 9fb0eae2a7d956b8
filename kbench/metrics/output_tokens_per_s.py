"""Every output token received inside the window, over its seconds."""
from kbench.record import tokens_in_window


def read(rec):
    t0, t1 = rec["window"]
    return sum(len(tokens_in_window(r, rec)) for r in rec["rows"]) / (t1 - t0)
