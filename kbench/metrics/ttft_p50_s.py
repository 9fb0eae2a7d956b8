"""Median time to first token over every request due in the window, from
when it was due to when its client received the token; a request with no
first token by the window's end counts (end - due). The median, not a
tail: a 51 s window holds some tens of requests, and no percentile above
the median has ten of them beyond it."""
from kbench.record import due_in_window
from kbench.yardstick import percentile


def read(rec):
    t1 = rec["window"][1]
    vals = [(r["times"][0] if r["times"] and r["times"][0] <= t1 else t1) - r["due"]
            for r in due_in_window(rec)]
    return percentile(vals, 50)
